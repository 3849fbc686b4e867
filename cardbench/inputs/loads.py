"""The loads of a traffic mix, drawn from the seed: one general generator
for every traffic file.

A traffic file names its entry (a module of ``cardbench/entries/``: how a
call hands its block of load cases to the program), its block width
(``block``: the load cases a call) and, under ``load``, the rule its loads
follow (``load.rule``, a module of ``cardbench/rules/``) with the rule's
parameters.  A rule draws each call's columns; a column is a sum of the
configuration's load patterns, each at its factor, optionally with every
loaded node's magnitude scaled by a factor of its own (``rough``).

Call k draws from its own generator, seeded by (seed, k): the same seed
gives the same loads whatever the window's length.
"""

from __future__ import annotations

import numpy as np

#: the load patterns: the configuration's nodal load magnitudes (the x
#: components of its F) in component x, y or z of the same nodes, so "x" is
#: the configuration's tension and "y", "z" its two shears on the same face
PATTERNS = {"x": 0, "y": 1, "z": 2}


class Loads:
    """The seeded loads of one run: ``case(k)`` is the k-th call's list of
    ``block`` columns."""

    def __init__(self, traffic: dict, seed: int, rule=None, entry=None):
        """``rule`` and ``entry``: the modules the traffic names, by default
        those of the repository's ``cardbench/``."""
        if rule is None or entry is None:
            from cardbench.registry import Registry

            reg = Registry()
            rule = rule or reg.module("rules", traffic["load"]["rule"])
            entry = entry or reg.module("entries", traffic["entry"])
        self.traffic = traffic
        self.entry = traffic["entry"]
        self.block = int(traffic.get("block", 1))
        if self.block not in getattr(entry, "BLOCKS", (self.block,)):
            raise ValueError(f"entry {self.entry!r} takes blocks of "
                             f"{entry.BLOCKS}, not {self.block}")
        rule.check(traffic["load"], self.block)
        self.rule = rule
        self.seed = int(seed)

    def case(self, k: int) -> list:
        rng = np.random.default_rng([self.seed, int(k)])
        return self.rule.draw(self.traffic["load"], rng, [self.seed, int(k)])


def pattern_vectors(F: np.ndarray) -> dict:
    """The load patterns of a model: its nodal x load magnitudes placed in
    component x, y or z of the same nodes."""
    mag = np.asarray(F, dtype=np.float64)[0::3]
    out = {}
    for p, c in PATTERNS.items():
        v = np.zeros(len(F))
        v[c::3] = mag
        out[p] = v
    return out


def column_vector(col: dict, patterns: dict) -> np.ndarray:
    """One column: the sum of its patterns, each at its factor, with each
    node's three components scaled by the node's own factor when the column
    is rough (drawn from the column's key, so the same every time)."""
    v = sum(f * patterns[p] for p, f in col["factors"].items())
    r = col.get("rough", 0.0)
    if r:
        rng = np.random.default_rng(col["key"])
        w = rng.uniform(1.0 - r, 1.0 + r, len(v) // 3)
        v = v * np.repeat(w, 3)
    return v
