"""The benchmark's registry: ``BENCHMARK.json`` and the files its names
point at.

Everything that belongs to one configuration, one traffic mix or one
metric sits in a file of its own, found by the name ``BENCHMARK.json``
gives it:

- a configuration: the ``file`` of its ``configs`` entry (a JSON object
  under ``cardbench/configs/``);
- a traffic mix: ``cardbench/traffic/<name>.json``;
- a metric: ``cardbench/metrics/<name>.py``, whose ``read(record)`` gives
  the metric's value or None;
- a traffic's load rule: ``cardbench/rules/<rule>.py``; its entry:
  ``cardbench/entries/<entry>.py``;
- a configuration's generator: ``cardbench/inputs/<generator>.py``, whose
  ``make_model(**params)`` builds the model.

So a cell, a configuration, a traffic mix, a load rule, an entry, a
generator or a metric is added by adding files and entries, with no
existing file edited.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

NAME_RE = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")

REPO = Path(__file__).resolve().parent.parent


def check_name(name: str) -> str:
    if not isinstance(name, str) or not NAME_RE.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


class Registry:
    """The benchmark of the checkout at ``root`` (the directory holding
    ``BENCHMARK.json`` and ``cardbench/``)."""

    def __init__(self, root: Path = REPO):
        self.root = Path(root).resolve()
        self.pkg = self.root / "cardbench"
        with open(self.root / "BENCHMARK.json", encoding="utf-8") as f:
            self.bench = json.load(f)
        self._modules = {}

    def _entry(self, key: str, name: str) -> dict:
        check_name(name)
        for e in self.bench.get(key, []):
            if e.get("name") == name:
                return e
        raise KeyError(f"BENCHMARK.json has no {key} entry {name!r}")

    def cell(self, name: str) -> dict:
        return self._entry("workloads", name)

    def config(self, name: str) -> dict:
        """The configuration file of ``configs`` entry ``name``, with its
        name."""
        entry = self._entry("configs", name)
        path = (self.root / entry["file"]).resolve()
        if self.pkg not in path.parents:
            raise ValueError(f"configuration file {entry['file']!r} lies "
                             "outside cardbench/")
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        return dict(data, name=name)

    def traffic(self, name: str) -> dict:
        path = self.pkg / "traffic" / f"{check_name(name)}.json"
        with open(path, encoding="utf-8") as f:
            return json.load(f)

    def metrics(self, cell: str, kind: str) -> list:
        """The ``end_to_end`` or ``per_layer`` entries that apply to cell
        ``cell``: those without a ``workloads`` key and those that list
        it."""
        return [m for m in self.bench.get(kind, [])
                if "workloads" not in m or cell in m["workloads"]]

    def module(self, kind: str, name: str):
        """``cardbench/<kind>/<name>.py`` of this checkout, loaded once."""
        key = (kind, check_name(name))
        if key not in self._modules:
            path = self.pkg / kind / f"{name}.py"
            if not path.is_file():
                raise KeyError(f"no {kind} module {name!r}: {path}")
            spec = importlib.util.spec_from_file_location(
                f"cardbench_{kind}_" + re.sub(r"\W", "_", name), path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._modules[key] = mod
        return self._modules[key]

    def reader(self, name: str):
        """The ``read`` function of ``cardbench/metrics/<name>.py``."""
        return self.module("metrics", name).read
