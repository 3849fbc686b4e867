"""A temporary benchmark beside the real one, for the tests: a copy of
``BENCHMARK.json`` and of ``cardbench/``'s data, readers, rules, entries
and generators, with small
configurations and cells added the way a later change adds them (new
files and new entries)."""

import json
import shutil
from pathlib import Path

from cardbench.registry import REPO


def bench_copy(tmp_path: Path, nx: int = 6, octree: bool = False) -> Path:
    """A checkout-shaped copy at ``tmp_path/root`` with cell
    ``cube<nx>.step`` (the cube150 configuration at nx cells a side) and,
    with ``octree``, ``oct3.step`` (octree22 on a 3^3 base at level 2)."""
    root = tmp_path / "root"
    (root / "cardbench").mkdir(parents=True)
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    for d in ("configs", "traffic", "metrics", "rules", "entries", "inputs"):
        shutil.copytree(REPO / "cardbench" / d, root / "cardbench" / d,
                        ignore=shutil.ignore_patterns("__pycache__"))
    add_config(root, f"cube{nx}", "cube150", {"nx": nx})
    if octree:
        add_config(root, "oct3", "octree22",
                   {"nx0": 3, "ny0": 3, "nz0": 3, "max_level": 2,
                    "n_incl": 2})
    return root


def add_config(root: Path, name: str, like: str, params: dict,
               traffic: str = "step", **entries) -> None:
    """Add configuration ``name`` (configuration ``like`` with ``params``
    changed) and cell ``<name>.<traffic>`` to the copy at ``root``."""
    src = json.loads((root / "cardbench" / "configs" / f"{like}.json")
                     .read_text())
    src["params"] = dict(src["params"], **params)
    src.pop("n_dof", None)
    (root / "cardbench" / "configs" / f"{name}.json").write_text(
        json.dumps(src))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"] if c["name"] == like)
    bench["configs"].append(dict(entry, name=name,
                                 file=f"cardbench/configs/{name}.json"))
    bench["workloads"].append({"name": f"{name}.{traffic}", "config": name,
                               "traffic": traffic, "chips": 1,
                               "why": "a small test cell", **entries})
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
