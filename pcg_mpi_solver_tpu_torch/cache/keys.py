"""Content-addressed keys of the partition cache.

A cache entry is valid iff everything that shaped its content hashes the
same: the model bundle, the partition and solver knobs, and the code
that produced it.  The last part is covered by a sha256 of the sources
that shape an entry (``CODE_SOURCES``, read as ``native.library_path``
reads its own), ``CACHE_SCHEMA`` (bumped on any change of how an entry
is serialized), the port's ``__version__`` and its package name in
every key: a cache directory shared across commits never hands code an
entry that other code built.  The package name keeps the port's entries apart from the JAX package's in a shared
directory: each package pickles its own classes, and a JAX entry loaded
here would import JAX.

The port of ``pcg_mpi_solver_tpu/cache/keys.py``'s monolithic key
(``_hash_update``, ``model_fingerprint``, ``array_hash``, ``_digest``,
``partition_cache_key``); the shard and glue keys belong to the
multi-process build, ROADMAP queue 1 item 12.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

from pcg_mpi_solver_tpu_torch import __version__

# The port's own schema counter.  Bump on any change to how entries are
# serialized (a change of the code that builds them changes
# ``code_hash``); additive key fields need no bump (they change the key
# hash by themselves).
CACHE_SCHEMA = 1

# the package whose classes an entry pickles
PACKAGE = "pcg_mpi_solver_tpu_torch"

# Monkeypatchable in tests to simulate a version bump without editing the
# package.
PACKAGE_VERSION = __version__

_PKG = Path(__file__).resolve().parents[1]
# The sources whose code shapes a cached entry: the partitions
# (parallel/, the native partitioner and prep), the mg hierarchy
# (ops/mg.py, the element stiffness it coarsens) and the mg fine bound
# (power-iteration matvecs on the operators of ops/ and csrc/).
CODE_SOURCES = tuple(sorted(
    [_PKG / "models" / "element.py"]
    + list((_PKG / "parallel").glob("*.py"))
    + [_PKG / "ops" / f for f in ("matvec.py", "mg.py", "precond.py",
                                  "structured_matvec.py")]
    + list((_PKG / "native").glob("*.cpp"))
    + list((_PKG / "csrc").glob("*.cu*"))))


def _hash_update(h, obj: Any) -> None:
    """Deterministic recursive hash of numpy arrays, builtins and
    dataclasses (dict keys canonicalized by repr sort): the JAX package's
    walk, so a model hashes the same in both packages."""
    if obj is None:
        h.update(b"\x00none")
    elif isinstance(obj, np.ndarray):
        a = np.ascontiguousarray(obj)
        h.update(f"nd:{a.shape}:{a.dtype}".encode())
        h.update(a.tobytes())
    elif isinstance(obj, (bool, int, float, str, bytes, complex,
                          np.integer, np.floating, np.bool_)):
        h.update(f"{type(obj).__name__}:{obj!r}".encode())
    elif isinstance(obj, dict):
        h.update(f"dict:{len(obj)}".encode())
        for k in sorted(obj, key=repr):
            h.update(repr(k).encode())
            _hash_update(h, obj[k])
    elif isinstance(obj, (list, tuple)):
        h.update(f"seq:{len(obj)}".encode())
        for v in obj:
            _hash_update(h, v)
    elif dataclasses.is_dataclass(obj):
        h.update(type(obj).__name__.encode())
        for f in dataclasses.fields(obj):
            h.update(f.name.encode())
            _hash_update(h, getattr(obj, f.name))
    else:
        h.update(repr(obj).encode())


def model_fingerprint(model) -> str:
    """Content hash of a whole ModelData bundle (every dataclass field:
    topology, loads, BCs, element library, materials, octree and grid
    metadata): what makes the cache safe against a silently edited
    model."""
    h = hashlib.sha256()
    _hash_update(h, model)
    return h.hexdigest()


def array_hash(arr) -> str:
    """Short content hash of one array (e.g. an explicit elem_part map)."""
    a = np.ascontiguousarray(np.asarray(arr))
    h = hashlib.sha256(f"{a.shape}:{a.dtype}".encode())
    h.update(a.tobytes())
    return h.hexdigest()[:16]


def code_hash() -> str:
    """sha256 of ``CODE_SOURCES``' names and contents."""
    h = hashlib.sha256()
    for path in CODE_SOURCES:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()


def _digest(payload: Dict[str, Any]) -> str:
    payload = dict(payload)
    payload["code"] = code_hash()
    payload["cache_schema"] = CACHE_SCHEMA
    payload["version"] = PACKAGE_VERSION
    payload["package"] = PACKAGE
    blob = json.dumps(payload, sort_keys=True, default=repr).encode()
    return hashlib.sha256(blob).hexdigest()[:32]


def partition_cache_key(model_fp: str, *, n_parts: int, backend: str,
                        dtype: str, method: str = "n/a",
                        elem_part_hash: Optional[str] = None,
                        pad_multiple: int = 8,
                        extra: Optional[Dict[str, Any]] = None) -> str:
    """Key of one serialized entry: model content + every knob that shapes
    it.  ``extra`` carries backend-specific knobs (hybrid block size and
    merge, whether the native partitioner took ``method='auto'``, the mg
    levels, ...)."""
    return _digest({
        "kind": "partition",
        "model": model_fp,
        "n_parts": int(n_parts),
        "backend": backend,
        "dtype": dtype,
        "method": method,
        "elem_part": elem_part_hash,
        "pad_multiple": int(pad_multiple),
        "extra": extra or {},
    })
