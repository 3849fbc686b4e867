"""Load rule ``columns``: column j of each call's block follows
``columns[j]`` of the traffic's ``load``, so a step traffic (block 1) has
one column spec and a block of R has R.

A column spec is ``{"pattern": p, "low": a, "high": b}``, the pattern p at a
factor uniform in [a, b), or ``{"mix": [p, ...], "low": a, "high": b}``, a
sum of the patterns, each at a factor of its own drawn so.  Optional keys:

- ``"signed": true``: each factor takes a sign drawn from the seed, so the
  shears of a mix point either way;
- ``"rough": r`` (0 <= r < 1): every loaded node's magnitude is scaled by
  its own factor uniform in [1 - r, 1 + r), a traction that varies over
  the face; no two cases then share a load direction, not even as a
  combination of earlier cases.

The patterns are ``loads.PATTERNS``: the configuration's nodal load
magnitudes in component x, y or z of the same nodes.
"""

from cardbench.inputs.loads import PATTERNS


def check(spec: dict, block: int) -> None:
    """Raise ValueError for a spec this rule cannot follow."""
    cols = spec.get("columns", [])
    if block < 1 or len(cols) != block:
        raise ValueError("the rule 'columns' takes one column spec a block "
                         f"column: block {block}, {len(cols)} specs")
    for c in cols:
        names = c.get("mix") or [c.get("pattern")]
        bad = [p for p in names if p not in PATTERNS]
        if bad:
            raise ValueError(f"unknown load pattern(s) {bad}")
        if not float(c["low"]) < float(c["high"]):
            raise ValueError(f"a column's low must lie under its high: {c}")
        if not 0.0 <= float(c.get("rough", 0.0)) < 1.0:
            raise ValueError(f"rough must lie in [0, 1): {c}")


def draw(spec: dict, rng, key: list) -> list:
    """The columns of one call: ``{"factors": {pattern: factor}, "rough":
    r, "key": key + [j]}`` each; ``key`` seeds the nodal factors."""
    cols = []
    for j, c in enumerate(spec["columns"]):
        names = c.get("mix") or [c["pattern"]]
        f = {p: float(rng.uniform(c["low"], c["high"])) for p in names}
        if c.get("signed"):
            f = {p: v * float(rng.choice((-1.0, 1.0))) for p, v in f.items()}
        cols.append({"factors": f, "rough": float(c.get("rough", 0.0)),
                     "key": [*key, j]})
    return cols
