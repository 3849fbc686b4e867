"""Device kernels a Krylov trip (device): the kernels of the profiled call
over its trips, the launches the host queues a trip.  Moves ``case_s``."""


def read(rec):
    p = rec.get("profile")
    if not p or not p["trips"]:
        return None
    k = p["summary"]["kernels"]
    return k / p["trips"] if k else None
