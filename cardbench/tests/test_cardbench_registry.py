"""Data-driven: a configuration, a traffic mix and a metric are added as new
files and entries, and the harness finds them by name with no file that
was there edited."""

import hashlib
import json

from cardbench.harness import run
from cardbench.registry import Registry
from cardbench.tests.bench_copy import add_config, bench_copy

NEW_METRIC = '''"""Load cases a call, a test metric added as a file."""


def read(rec):
    c = rec["counters"]
    return c["cases"] / c["calls"]
'''

BLOCK2 = {"entry": "solve_many", "block": 2,
          "load": {"rule": "columns", "columns": [
              {"pattern": "x", "low": 0.5, "high": 2.0},
              {"mix": ["y", "z"], "low": -1.0, "high": 1.0}]},
          "why": "blocks of two load cases through Solver.solve_many"}


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "cardbench").rglob("*") if p.is_file()}


def test_added_config_traffic_and_metric_are_found_by_name(tmp_path):
    root = bench_copy(tmp_path)
    before = _digests(root)
    bench_before = json.loads((root / "BENCHMARK.json").read_text())

    # the additions: three new files and their entries
    (root / "cardbench" / "traffic" / "block2.json").write_text(
        json.dumps(BLOCK2))
    (root / "cardbench" / "metrics" / "cases_per_call.py").write_text(
        NEW_METRIC)
    add_config(root, "cube5", "cube150", {"nx": 5, "ny": 4, "nz": 3},
               traffic="block2")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "cases_per_call", "unit": "count", "better": "higher",
        "source": "program_counter", "layer": "solver driver",
        "moves": "case_s", "workloads": ["cube5.block2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    after = _digests(root)
    assert {k: after[k] for k in before} == before      # nothing edited
    assert set(after) - set(before) == {
        p.relative_to(root) for p in (
            root / "cardbench/traffic/block2.json",
            root / "cardbench/metrics/cases_per_call.py",
            root / "cardbench/configs/cube5.json")}
    for key in bench_before:                            # entries only added
        old = bench_before[key]
        assert bench[key][:len(old)] == old if isinstance(old, list) \
            else bench[key] == old

    reg = Registry(root)
    assert reg.cell("cube5.block2")["traffic"] == "block2"
    assert reg.config("cube5")["params"]["nz"] == 3
    assert reg.traffic("block2")["block"] == 2
    assert "cases_per_call" in [m["name"] for m in
                                reg.metrics("cube5.block2", "per_layer")]
    assert "cases_per_call" not in [m["name"] for m in
                                    reg.metrics("cube6.step", "per_layer")]

    res = run("cube5.block2", 2**31 + 3, 0.3, True, root=root,
              device="cpu")
    assert res["correct"], res["checks"]
    assert res["metrics"]["cases_per_call"]["value"] == 2.0
    assert res["attempted"] % 2 == 0 and res["attempted"] >= 4
    e2e = run("cube5.block2", 9, 0.3, False, root=root, device="cpu")
    assert set(e2e["metrics"]) == {"case_s", "setup_s"}   # no card peak
    assert "cases_per_call" not in run("cube6.step", 9, 0.2, True,
                                       root=root, device="cpu")["metrics"]


SHEAR = {"entry": "step", "block": 1,
         "load": {"rule": "columns", "columns": [
             {"mix": ["y", "z"], "low": 0.5, "high": 1.0, "signed": True,
              "rough": 0.1}]},
         "why": "seeded shears through Solver.step"}

ALTERNATE = {"entry": "solve_one", "block": 1,
             "load": {"rule": "alternate", "low": 0.5, "high": 2.0},
             "why": "tension and shear in turns, one column a solve_many"}

ALTERNATE_RULE = '''"""Case k loads pattern x when k is even, y when odd, at a seeded
factor: a rule added as a file."""


def check(spec, block):
    if block != 1:
        raise ValueError("one column a call")


def draw(spec, rng, key):
    p = "xy"[key[-1] % 2]
    return [{"factors": {p: float(rng.uniform(spec["low"], spec["high"]))},
             "rough": 0.0, "key": [*key, 0]}]
'''

SOLVE_ONE_ENTRY = '''"""One column a call through Solver.solve_many: an entry added as a
file."""

BLOCKS = (1,)


def prepare(solver, model):
    return None


def solve(solver, fb):
    res = solver.solve_many(fb)
    return int(res.trips), [int(f) for f in res.flags], res.x


def answer(solver, handle):
    return solver.displacement_global_many(handle)


def dirichlet(model):
    return None
'''

SLAB_GENERATOR = '''"""A cube generator under a name of its own: a generator added as a
file."""

from cardbench.inputs.cube import make_cube_model


def make_model(n, **kw):
    return make_cube_model(n, ny=n, nz=max(1, n // 2), **kw)
'''


def test_added_step_mix_rule_entry_and_generator_are_found_by_name(tmp_path):
    """A step traffic with a pattern mix, a load rule, an entry and a mesh
    generator, each added as a file and found by its name."""
    root = bench_copy(tmp_path)
    before = _digests(root)
    pkg = root / "cardbench"
    (pkg / "traffic" / "shear.json").write_text(json.dumps(SHEAR))
    (pkg / "traffic" / "alternate.json").write_text(json.dumps(ALTERNATE))
    (pkg / "rules" / "alternate.py").write_text(ALTERNATE_RULE)
    (pkg / "entries" / "solve_one.py").write_text(SOLVE_ONE_ENTRY)
    (pkg / "inputs" / "slab.py").write_text(SLAB_GENERATOR)
    cfg = json.loads((pkg / "configs" / "cube150.json").read_text())
    cfg.update(generator="slab", params=dict(
        {k: v for k, v in cfg["params"].items() if k != "nx"}, n=4))
    (pkg / "configs" / "slab4.json").write_text(json.dumps(cfg))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    like = next(c for c in bench["configs"] if c["name"] == "cube150")
    bench["configs"].append(dict(like, name="slab4",
                                 file="cardbench/configs/slab4.json"))
    for t in ("shear", "alternate"):
        bench["workloads"].append({"name": f"slab4.{t}", "config": "slab4",
                                   "traffic": t, "chips": 1,
                                   "why": "a small test cell"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digests(root)
    assert {k: after[k] for k in before} == before      # nothing edited

    res = run("slab4.shear", 2**31 + 9, 0.3, False, root=root, device="cpu")
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 2
    res = run("slab4.alternate", 4, 0.3, True, root=root, device="cpu")
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 3


def test_names_outside_the_rules_are_refused(tmp_path):
    import pytest

    reg = Registry(bench_copy(tmp_path))
    for bad in ("../step", "a/b", "", "x" * 65, "with space"):
        with pytest.raises(ValueError):
            reg.traffic(bad)
    with pytest.raises(KeyError):
        reg.cell("nope.step")
