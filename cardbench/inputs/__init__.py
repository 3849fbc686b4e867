"""The benchmark's inputs: the model a configuration names, and the loads a
traffic mix draws from the seed.

A configuration's ``generator`` names a module of this folder whose
``make_model(**params)`` builds its model.  The generators are frozen
copies of the port's (``cube.py``, ``octree.py``), so a later change to the
port's ``models/`` cannot move the yardstick.  A configuration with ``"cache_model": true`` keeps its
built model under ``cardbench/.cache/models/``, keyed by the generator's
parameters and a hash of these sources: the first run of a checkout builds
it, later runs load it.
"""

from __future__ import annotations

import hashlib
import os
import pickle
from pathlib import Path

from cardbench.inputs.model_data import ModelData

#: the shared sources every built model depends on, besides its generator's
SHARED = ("element.py", "model_data.py")


def model_key(config: dict, registry=None) -> str:
    """Hash of the generator, its parameters and the generator's sources."""
    from cardbench.registry import Registry, check_name

    inputs_dir = (registry or Registry()).pkg / "inputs"
    h = hashlib.sha256()
    h.update(repr((config["generator"],
                   sorted(config["params"].items()))).encode())
    for fn in (f"{check_name(config['generator'])}.py", *SHARED):
        h.update((inputs_dir / fn).read_bytes())
    return h.hexdigest()[:16]


def build_model(config: dict, cache_dir: Path | None = None,
                registry=None) -> ModelData:
    """The configuration's model: built by its generator (the
    ``make_model`` of ``registry``'s ``inputs/<generator>.py``, by default
    the repository's), or loaded from ``cache_dir`` when the configuration
    asks for the model cache and an entry of this key is there (a pickle
    this function wrote)."""
    from cardbench.registry import Registry

    registry = registry or Registry()
    gen = registry.module("inputs", config["generator"]).make_model
    if not (config.get("cache_model") and cache_dir is not None):
        return gen(**config["params"])
    path = (Path(cache_dir)
            / f"{config['name']}-{model_key(config, registry)}.pkl")
    if path.exists():
        with open(path, "rb") as f:
            return pickle.load(f)
    model = gen(**config["params"])
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".tmp{os.getpid()}")
    try:
        with open(tmp, "wb") as f:
            pickle.dump(model, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, path)
    finally:
        if tmp.exists():
            tmp.unlink()
    return model
