"""Share of its roofline that one K·p reaches (operator): the least time
of one K·p on this card (``_roofline.py``, from the mesh's counts) over the
device time a ``pcg/matvec`` range takes in the profiled call.  Moves
``case_s``."""

from cardbench.metrics import _roofline


def read(rec):
    p = rec.get("profile")
    if not p:
        return None
    n = p["summary"]["ranges"].get("pcg/matvec", 0)
    us = p["summary"]["phase_us"]["matvec"]
    m = rec["mesh"]
    counts = _roofline.matvec_counts(m["n_dof"], m["n_elem"],
                                     m["ke_entries"], m["itemsize"],
                                     m["block"])
    bound = _roofline.bound_s(counts, m["itemsize"], rec["device_kind"])
    if not n or not us or bound is None:
        return None
    return 100.0 * bound["s"] / (us * 1e-6 / n)
