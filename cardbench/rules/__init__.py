"""Load rules: one module a rule, ``<name>.py``, found by the ``rule`` a
traffic file's ``load`` names.  A rule has ``check(spec, block)``, which
raises ValueError for a spec it cannot follow, and ``draw(spec, rng,
key)``, the columns of one call (see ``inputs/loads.py``)."""
