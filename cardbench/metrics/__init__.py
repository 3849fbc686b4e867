"""Per-layer metrics: one reader a metric, ``<name>.py`` with ``read(record)``
returning the metric's value, or None when the run has nothing to read
(then the harness leaves the metric out of the line).

Modules whose names start with ``_`` are the readers' shared arithmetic,
not metrics: ``_profile.py`` (a torch.profiler Chrome trace as device ops
by ``pcg/*`` phase, busy time, idle gaps) and ``_roofline.py`` (the least
time of one K·p on a card, from the mesh's counts and the card's peaks).
"""
