"""ctypes binding of the port's native (C++) host library.

The counterpart of the JAX package's ``native.py``: the dual-graph mesh
partitioner (the reference's METIS call, ``run_metis.py:84-88``) and the
partition build's prep loops, from the port's own copies of the sources
(``native/partition.cpp``, ``native/prep.cpp``; the algorithms as the JAX
package has them, so the same inputs and seed give the same arrays).
The library is built with ``g++`` at first use, as ``ops/kernels.py``
builds the CUDA kernels: into ``build/native/`` at the repository root,
keyed by a hash of the sources and the flags, published atomically.
Nothing is built when the module is imported.

``PCG_TPU_NO_NATIVE`` (any non-empty value) turns the library off, as in
the JAX package: :func:`available` is False, so
``partition_method="auto"`` takes RCB and ``"graph"`` raises, and the
prep helpers take their numpy forms (the same values).

No silent fallback: where the JAX package quietly takes RCB when its
library does not build, here a failed build raises
:class:`NativeBuildError` with ``g++``'s output, for ``"graph"`` and
``"auto"`` alike, because a different partition moves the iteration
counts.  Only the prep helpers (:func:`csr_take`,
:func:`unique_renumber`, :func:`sort_i32`), whose numpy forms give the
same arrays, return None then and let the caller take those forms.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

SRC_DIR = Path(__file__).resolve().parent / "native"
SOURCES = ("partition.cpp", "prep.cpp")
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "native"
# the JAX package's native/Makefile flags
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra",
             "-fno-exceptions", "-shared")


class NativeBuildError(RuntimeError):
    """The native library did not build (the message holds the compiler's
    output)."""


_lib: Optional[ctypes.CDLL] = None
_error: Optional[NativeBuildError] = None


def disabled() -> bool:
    """``PCG_TPU_NO_NATIVE`` is set: the library is off."""
    return bool(os.environ.get("PCG_TPU_NO_NATIVE"))


def library_path() -> Path:
    key = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        key.update((SRC_DIR / name).read_bytes())
    return BUILD_DIR / f"libpcgnative-{key.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if it is not built yet; returns its path.
    Raises :class:`NativeBuildError` with the compiler's output."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if not cxx:
        raise NativeBuildError("g++ not found on PATH; the native graph "
                               "partitioner cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    try:
        res = subprocess.run(
            [cxx, *CXX_FLAGS, "-o", str(tmp),
             *(str(SRC_DIR / n) for n in SOURCES)],
            capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise NativeBuildError(f"{cxx} did not run: {e}") from e
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(
            f"{cxx} failed ({res.returncode}) building the native "
            f"library:\n{res.stderr}{res.stdout}")
    # atomic publish: a concurrent build writes its own tmp file and
    # replaces with identical bytes
    os.replace(tmp, out)
    return out


def _declare(lib: ctypes.CDLL) -> None:
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.pcgn_part_graph.restype = ctypes.c_int
    lib.pcgn_part_graph.argtypes = [
        ctypes.c_int64, i64p, i64p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_uint64, i32p]
    lib.pcgn_part_mesh_dual.restype = ctypes.c_int
    lib.pcgn_part_mesh_dual.argtypes = [
        ctypes.c_int64, ctypes.c_int64, i64p, i64p,
        ctypes.c_int, ctypes.c_int, ctypes.c_uint64, i32p]
    lib.pcgn_edge_cut.restype = ctypes.c_int64
    lib.pcgn_edge_cut.argtypes = [ctypes.c_int64, i64p, i64p,
                                  ctypes.c_void_p, i32p]
    lib.pcgn_csr_take.restype = ctypes.c_int64
    lib.pcgn_csr_take.argtypes = [i64p, i64p, i64p, ctypes.c_int64, i64p]
    lib.pcgn_unique_renumber.restype = ctypes.c_int64
    lib.pcgn_unique_renumber.argtypes = [i64p, ctypes.c_int64, i64p,
                                         ctypes.c_void_p]  # loc nullable
    lib.pcgn_sort_i32.restype = None
    lib.pcgn_sort_i32.argtypes = [i32p, ctypes.c_int64, i32p, i32p]


def load() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if needed (once per process); None
    under ``PCG_TPU_NO_NATIVE``.  A failed build raises
    :class:`NativeBuildError`, now and at every later call."""
    global _lib, _error
    if disabled():
        return None
    if _lib is not None:
        return _lib
    if _error is not None:
        raise _error
    try:
        lib = ctypes.CDLL(str(build()))
    except OSError as e:
        _error = NativeBuildError(f"the native library did not load: {e}")
        raise _error from e
    except NativeBuildError as e:
        _error = e
        raise
    _declare(lib)
    _lib = lib
    return _lib


def available() -> bool:
    """True when the library is on (loads); False only under
    ``PCG_TPU_NO_NATIVE``.  A failed build raises."""
    return load() is not None


def _prep_lib() -> Optional[ctypes.CDLL]:
    """The library for the prep helpers, or None when it is off or did
    not build (their callers then take the numpy forms: the same
    values)."""
    try:
        return load()
    except NativeBuildError:
        return None


def _required() -> ctypes.CDLL:
    lib = load()
    if lib is None:
        raise RuntimeError(
            "the native graph partitioner is off (PCG_TPU_NO_NATIVE is "
            "set); use partition method 'rcb', 'slab2' or 'auto'")
    return lib


# ---------------------------------------------------------------------------
# Partitioning entry points
# ---------------------------------------------------------------------------

def part_mesh_dual(eptr: np.ndarray, eind: np.ndarray, n_node: int,
                   n_parts: int, ncommon: int = 1,
                   seed: int = 0) -> np.ndarray:
    """Partition a mesh by its dual graph (elements sharing >= ncommon
    nodes are adjacent; edge weight = shared nodes), the call shape of
    the reference's METIS use (run_metis.py:88).  Returns an (n_elem,)
    int32 part map.  Raises when the library is off or did not build."""
    lib = _required()
    eptr = np.ascontiguousarray(eptr, dtype=np.int64)
    eind = np.ascontiguousarray(eind, dtype=np.int64)
    n_elem = len(eptr) - 1
    part = np.empty(n_elem, dtype=np.int32)
    rc = lib.pcgn_part_mesh_dual(n_elem, int(n_node), eptr, eind,
                                 int(ncommon), int(n_parts), int(seed), part)
    if rc != 0:
        raise ValueError(f"part_mesh_dual refused its arguments (n_elem="
                         f"{n_elem}, n_parts={n_parts}, ncommon={ncommon})")
    return part


def part_graph(xadj: np.ndarray, adjncy: np.ndarray, n_parts: int,
               adjwgt: Optional[np.ndarray] = None,
               vwgt: Optional[np.ndarray] = None,
               seed: int = 0) -> np.ndarray:
    """k-way partition of a CSR graph (unit weights where None).  Raises
    when the library is off or did not build."""
    lib = _required()
    xadj = np.ascontiguousarray(xadj, dtype=np.int64)
    adjncy = np.ascontiguousarray(adjncy, dtype=np.int64)
    n = len(xadj) - 1
    part = np.empty(n, dtype=np.int32)
    # the converted arrays stay alive in locals for the C call
    aw = (np.ascontiguousarray(adjwgt, dtype=np.int64)
          if adjwgt is not None else None)
    vw = (np.ascontiguousarray(vwgt, dtype=np.int64)
          if vwgt is not None else None)
    rc = lib.pcgn_part_graph(n, xadj, adjncy,
                             aw.ctypes.data if aw is not None else None,
                             vw.ctypes.data if vw is not None else None,
                             int(n_parts), int(seed), part)
    if rc != 0:
        raise ValueError(f"part_graph refused its arguments (n={n}, "
                         f"n_parts={n_parts})")
    return part


def edge_cut_np(xadj: np.ndarray, adjncy: np.ndarray,
                part: np.ndarray) -> int:
    """Edge cut of a partition (unit edge weights), in numpy."""
    src = np.repeat(np.arange(len(xadj) - 1), np.diff(xadj))
    part = np.asarray(part)
    return int((part[src] != part[np.asarray(adjncy)]).sum() // 2)


def edge_cut(xadj: np.ndarray, adjncy: np.ndarray, part: np.ndarray) -> int:
    """Edge cut of a partition (unit edge weights); :func:`edge_cut_np`
    when the library is off."""
    lib = _prep_lib()
    if lib is None:
        return edge_cut_np(xadj, adjncy, part)
    xadj = np.ascontiguousarray(xadj, dtype=np.int64)
    adjncy = np.ascontiguousarray(adjncy, dtype=np.int64)
    part = np.ascontiguousarray(part, dtype=np.int32)
    return int(lib.pcgn_edge_cut(len(xadj) - 1, xadj, adjncy, None, part))


# ---------------------------------------------------------------------------
# Prep helpers of the partition build (None: take the numpy form)
# ---------------------------------------------------------------------------

_PREP_THRESHOLD = 4096  # below this, numpy's C loops win on call overhead


def csr_take(flat: np.ndarray, offset: np.ndarray,
             elems: np.ndarray) -> Optional[np.ndarray]:
    """Ragged gather flat[offset[e]:offset[e+1]] for e in elems, in the
    caller's dtype; None below the threshold or without the library."""
    if len(elems) < _PREP_THRESHOLD:
        return None
    lib = _prep_lib()
    if lib is None:
        return None
    orig_dtype = np.asarray(flat).dtype
    flat = np.ascontiguousarray(flat, dtype=np.int64)
    offset = np.ascontiguousarray(offset, dtype=np.int64)
    elems = np.ascontiguousarray(elems, dtype=np.int64)
    total = int((offset[elems + 1] - offset[elems]).sum())
    out = np.empty(total, dtype=np.int64)
    lib.pcgn_csr_take(flat, offset, elems, len(elems), out)
    # a bool mask stays a bool mask
    return out if orig_dtype == np.int64 else out.astype(orig_dtype)


def unique_renumber(ids: np.ndarray, renumber: bool = True):
    """(sorted unique ids as int64, int32 local index of each input id);
    with ``renumber=False`` the second element is None.  None below the
    threshold or without the library."""
    if len(ids) < _PREP_THRESHOLD:
        return None
    lib = _prep_lib()
    if lib is None:
        return None
    ids = np.ascontiguousarray(ids, dtype=np.int64)
    uniq = np.empty(len(ids), dtype=np.int64)
    loc = np.empty(len(ids), dtype=np.int32) if renumber else None
    nu = lib.pcgn_unique_renumber(
        ids, len(ids), uniq, loc.ctypes.data if loc is not None else None)
    return uniq[:nu].copy(), loc


def sort_i32(keys: np.ndarray):
    """(stable argsort perm, sorted keys) of int32 keys, both int32; None
    below the threshold or without the library."""
    if len(keys) < _PREP_THRESHOLD:
        return None
    lib = _prep_lib()
    if lib is None:
        return None
    keys = np.ascontiguousarray(keys, dtype=np.int32)
    perm = np.empty(len(keys), dtype=np.int32)
    skeys = np.empty(len(keys), dtype=np.int32)
    lib.pcgn_sort_i32(keys, len(keys), perm, skeys)
    return perm, skeys


def build_dual_graph_np(eptr: np.ndarray, eind: np.ndarray, n_node: int,
                        ncommon: int = 1):
    """The dual graph in pure numpy (the test oracle): (xadj, adjncy) CSR
    of element adjacency, elements adjacent iff they share >= ncommon
    nodes."""
    n_elem = len(eptr) - 1
    src = np.repeat(np.arange(n_elem, dtype=np.int64), np.diff(eptr))
    order = np.argsort(eind, kind="stable")
    by_node_elem = src[order]
    node_cnt = np.bincount(eind, minlength=n_node)
    node_off = np.concatenate([[0], np.cumsum(node_cnt)])
    pairs = []
    for nd in range(n_node):
        es = by_node_elem[node_off[nd]:node_off[nd + 1]]
        if len(es) > 1:
            a, b = np.meshgrid(es, es, indexing="ij")
            m = a != b
            pairs.append(np.stack([a[m], b[m]], axis=1))
    if not pairs:
        return (np.zeros(n_elem + 1, dtype=np.int64),
                np.zeros(0, dtype=np.int64))
    pr = np.concatenate(pairs)
    key = pr[:, 0] * n_elem + pr[:, 1]
    uniq, counts = np.unique(key, return_counts=True)
    uniq = uniq[counts >= ncommon]
    a = uniq // n_elem
    b = uniq % n_elem
    xadj = np.concatenate(
        [[0], np.cumsum(np.bincount(a, minlength=n_elem))]).astype(np.int64)
    return xadj, b.astype(np.int64)
