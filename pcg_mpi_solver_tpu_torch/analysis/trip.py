"""Trip recordings of the port's host-driven PCG loop.

The counterpart of the JAX package's ``analysis/jaxpr_utils.py``.  The
JAX package proves its structural claims on traced jaxprs; the port has
no traced program (``solver/pcg.py`` drives the loop from the host, one
trip at a time), so the contract lint reads what a trip RAN instead.  A
:class:`TripRecorder` logs, while a real solve runs:

* every aten op, through a ``TorchDispatchMode``: its name, the dtypes
  and shapes of its tensors, and the storages it reads and writes (so
  data dependence can be followed, :func:`dependence`);
* the collectives, as one op each (``dist.all_reduce``, ``dist.halo``,
  ``dist.all_gather``) carrying the increments of
  ``parallel/distributed.Group.counts`` they made;
* the slab kernel's launches, as one ``kernel.structured_matvec`` op
  carrying the increment of ``ops/structured_matvec.LAUNCHES`` (the
  ctypes launch on the card is invisible to the dispatch mode, and the
  plain version on the CPU is logged as this one op too, so both devices
  log the same trip);
* the host reads: ``pcg._read`` and the pipelined early read as
  ``host.read`` ops, and any other device->host sync (``.item()``, a
  copy to the host) where it happens;
* the host->device copies (``uploads``: a tensor made from host data on
  the CPU, a copy from the host on the card) with their sizes;
* the ``torch.profiler`` ranges (``pcg/matvec``, ``pcg/precond``,
  ``pcg/reduce``, ``pcg/axpy``), entered because the recording runs
  under the profiler, as ``range`` entries.

``solver/pcg.TRIP_PROBE`` marks where each trip starts (with its kind:
``iterate``, ``check``, ``prime``) and where a loop ends, which cuts the
log into :class:`Trip` windows.  :func:`record_trips` (``programs.py``)
runs the same solve capped at k and at k + 1 iterations and takes the
difference of the two runs' totals: it must equal the last trip's window
of the longer run, so setup and finalize stay apart from the loop.

This module imports torch only inside :class:`TripRecorder`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

#: size (elements) above which a trip's host->device copy is a
#: hot-loop-purity violation: a per-trip upload (the JAX package's
#: ``LOOP_CONST_THRESHOLD_ELEMS``).
UPLOAD_THRESHOLD_ELEMS = 4096

#: the counters of a trip (:meth:`Trip.counts`): aten ops, the
#: collectives of ``Group.counts``, kernel launches, host reads,
#: host->device copies, ops on a float64 tensor.
COUNTERS = ("aten_ops", "all_reduce", "halo", "halo_msgs", "all_gather",
            "launches", "host_reads", "uploads", "f64_ops")

GROUP_COUNTERS = ("all_reduce", "halo", "halo_msgs", "all_gather")

#: the range prefix of the loop's phases (obs/profview.PHASE_SCOPES keys)
PHASE_PREFIX = "pcg/"

# the pseudo-ops standing for work the dispatch mode cannot see whole
PSEUDO_OPS = ("dist.all_reduce", "dist.halo", "dist.all_gather",
              "kernel.structured_matvec", "host.read", "host.read_start")
# pseudo-ops that move data to the host: their dtypes are the read's
HOST_OPS = ("host.read", "host.read_start")


@dataclasses.dataclass
class Trip:
    """One trip of the loop as recorded: its ``kind`` and its ops, each a
    dict with ``op`` (name), ``in`` / ``out`` (storage ids), ``dt``
    (dtypes), ``sh`` (shapes), ``sc`` (the enclosing ``pcg/*`` ranges),
    ``n`` (counter increments) and, for uploads, ``up`` (elements); a
    profiler range entered in the trip is ``{"op": "range", "label":
    name}``."""

    kind: str
    ops: List[dict]

    def counts(self) -> Dict[str, int]:
        return sum_counts(self.ops)

    def uploads(self) -> List[int]:
        return [o["up"] for o in self.ops if "up" in o]

    def labels(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for o in self.ops:
            if o["op"] == "range":
                out[o["label"]] = out.get(o["label"], 0) + 1
        return out

    def launches(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for o in self.ops:
            for k, v in o.get("by", {}).items():
                out[k] = out.get(k, 0) + v
        return out

    def to_dict(self) -> dict:
        return {"kind": self.kind, "ops": self.ops}

    @classmethod
    def from_dict(cls, d: dict) -> "Trip":
        return cls(kind=d["kind"], ops=list(d["ops"]))


def sum_counts(ops: List[dict]) -> Dict[str, int]:
    """The :data:`COUNTERS` of a run of ops."""
    out = dict.fromkeys(COUNTERS, 0)
    for o in ops:
        if o["op"] == "range":
            continue
        if o["op"] not in PSEUDO_OPS:
            out["aten_ops"] += 1
        for k, v in o.get("n", {}).items():
            out[k] += v
    return out


def dependence(ops: List[dict], source: Callable[[int, dict], bool]
               ) -> List[bool]:
    """Forward data dependence over a window of ops: ``out[i]`` is True
    when op ``i`` reads a storage that some op ``j`` < ``i`` with
    ``source(j, op_j)`` wrote, directly or through ops in between.  An op
    that writes a storage it also reads (in place) keeps what was there
    (its taint is the union); a host value (a read, then a Python
    scalar) carries no storage, so dependence through the host is not
    followed."""
    tainted: set = set()
    out = []
    for i, o in enumerate(ops):
        if o["op"] == "range":
            out.append(False)
            continue
        reads = any(s in tainted for s in o["in"])
        out.append(reads)
        if reads or source(i, o):
            tainted.update(o["out"])
        else:
            # an op writing fresh values from untainted inputs clears
            # the storages it overwrites, unless it also reads them
            for s in o["out"]:
                if s not in o["in"]:
                    tainted.discard(s)
    return out


class TripRecorder:
    """Context manager recording every op, collective, launch, host read
    and trip mark of the solves run inside it (module docstring).
    ``device_type`` is the solve's ("cpu" or "cuda"): on the CPU a tensor
    made from host data is an upload, on the card a copy from the host
    is.  ``profile`` runs the recording under ``torch.profiler`` so the
    loop's phase ranges are entered.  ``inject_read``, the seeded
    violation of the hot-loop-purity rule, reads one more value to the
    host at the start of every trip, through ``pcg._read``."""

    def __init__(self, device_type: str = "cpu", profile: bool = True,
                 inject_read: bool = False):
        self.device_type = device_type
        self.profile = profile
        self.inject_read = inject_read
        self.ops: List[dict] = []
        self.marks: List[tuple] = []      # (kind, op index)
        self._ids: Dict[tuple, int] = {}
        self._keep: List[Any] = []
        self._scopes: List[str] = []
        self._quiet = 0
        self._undo: List[tuple] = []

    # -- storages ------------------------------------------------------
    def _sid(self, t) -> Optional[int]:
        """A small id of ``t``'s storage, stable over the recording (the
        storage is held, so its address cannot be reused)."""
        try:
            st = t.untyped_storage()
        except (RuntimeError, TypeError, NotImplementedError):
            return None
        ptr = st.data_ptr()
        if not ptr:
            return None
        key = (t.device.type, t.device.index, ptr)
        sid = self._ids.get(key)
        if sid is None:
            sid = self._ids[key] = len(self._ids)
            self._keep.append(st)
        return sid

    @staticmethod
    def _tensors(obj) -> list:
        import torch
        from torch.utils._pytree import tree_flatten

        return [t for t in tree_flatten(obj)[0]
                if isinstance(t, torch.Tensor)]

    def _log(self, op: str, ins, outs, n=None, **extra) -> None:
        tin, tout = self._tensors(ins), self._tensors(outs)
        rec = {"op": op,
               "in": [s for s in map(self._sid, tin) if s is not None],
               "out": [s for s in map(self._sid, tout) if s is not None],
               "dt": sorted({str(t.dtype).removeprefix("torch.")
                             for t in tin + tout}),
               "sh": [list(t.shape) for t in tin + tout],
               "sc": [s for s in self._scopes if s.startswith(PHASE_PREFIX)]}
        n = dict(n or {})
        if op not in HOST_OPS and "float64" in rec["dt"]:
            n["f64_ops"] = 1
        if n:
            rec["n"] = n
        rec.update(extra)
        self.ops.append(rec)

    # -- the dispatch mode -----------------------------------------------
    def _mode(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        rec = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                name = str(func)
                if name.startswith("profiler._record_function_enter"):
                    rec._scopes.append(str(args[0]))
                    if not rec._quiet:
                        rec.ops.append({"op": "range",
                                        "label": str(args[0])})
                elif name.startswith("profiler._record_function_exit"):
                    if rec._scopes:
                        rec._scopes.pop()
                elif not rec._quiet:
                    rec._aten(name, args, kwargs or {}, out)
                return out

        return _Mode()

    def _aten(self, name: str, args, kwargs, out) -> None:
        tin = self._tensors((args, kwargs))
        tout = self._tensors(out)
        n, extra = {}, {}
        src = {t.device.type for t in tin}
        dst = {t.device.type for t in tout}
        short = name.split(".")[1] if "." in name else name
        if short == "_local_scalar_dense":
            n["host_reads"] = 1
        elif short in ("_to_copy", "copy_") and "cpu" in dst \
                and src - {"cpu"}:
            n["host_reads"] = 1
        elif short in ("_to_copy", "copy_") and "cpu" in src \
                and dst - {"cpu"}:
            n["uploads"] = 1
            extra["up"] = int(tout[0].numel())
        elif short == "lift_fresh" and self.device_type == "cpu":
            n["uploads"] = 1
            extra["up"] = int(tout[0].numel()) if tout else 0
        self._log(name, (args, kwargs), out, n, **extra)

    # -- pseudo-ops ------------------------------------------------------
    def _wrap(self, owner, attr: str, make: Callable) -> None:
        orig = getattr(owner, attr)
        self._undo.append((owner, attr, orig))
        setattr(owner, attr, make(orig))

    def _quietly(self, fn, *a, **k):
        self._quiet += 1
        try:
            return fn(*a, **k)
        finally:
            self._quiet -= 1

    def _install(self) -> None:
        from pcg_mpi_solver_tpu_torch.ops import structured_matvec as smv
        from pcg_mpi_solver_tpu_torch.parallel import distributed, hybrid
        from pcg_mpi_solver_tpu_torch.parallel import structured
        from pcg_mpi_solver_tpu_torch.solver import pcg as pcg_mod

        rec = self

        def group_op(name, ins_of):
            def make(orig):
                def wrapped(grp, *a, **k):
                    if rec._quiet:
                        return orig(grp, *a, **k)
                    before = {c: grp.counts.get(c, 0)
                              for c in GROUP_COUNTERS}
                    out = rec._quietly(orig, grp, *a, **k)
                    n = {c: grp.counts.get(c, 0) - before[c]
                         for c in GROUP_COUNTERS}
                    rec._log(name, ins_of(a), out,
                             {c: v for c, v in n.items() if v})
                    return out
                return wrapped
            return make

        self._wrap(distributed.Group, "psum",
                   group_op("dist.all_reduce", lambda a: a[:1]))
        self._wrap(distributed.Group, "exchange_planes",
                   group_op("dist.halo", lambda a: a[:2]))
        self._wrap(distributed.Group, "gather",
                   group_op("dist.all_gather", lambda a: a[:1]))

        def kernel(orig):
            def wrapped(xg, ck, Ke, *a, **k):
                if rec._quiet:
                    return orig(xg, ck, Ke, *a, **k)
                before = dict(smv.LAUNCHES)
                y = rec._quietly(orig, xg, ck, Ke, *a, **k)
                by = {f"{v} {d}": smv.LAUNCHES[(v, d)] - before[(v, d)]
                      for (v, d) in smv.LAUNCHES
                      if smv.LAUNCHES[(v, d)] != before[(v, d)]}
                n = {"launches": sum(by.values())} if by else {}
                rec._log("kernel.structured_matvec", (xg, ck, Ke), y, n,
                         **({"by": by} if by else {}))
                return y
            return wrapped

        for mod in (structured, hybrid):
            self._wrap(mod, "structured_matvec", kernel)

        def read(orig):
            def wrapped(*ts):
                if rec._quiet:
                    return orig(*ts)
                out = rec._quietly(orig, *ts)
                rec._log("host.read", ts, (), {"host_reads": 1})
                return out
            return wrapped

        self._wrap(pcg_mod, "_read", read)

        def start(orig):
            def wrapped(er, t):
                if rec._quiet:
                    return orig(er, t)
                rec._quietly(orig, er, t)
                rec._log("host.read_start", (t,), ())
            return wrapped

        def wait(orig):
            def wrapped(er):
                if rec._quiet:
                    return orig(er)
                out = rec._quietly(orig, er)
                rec._log("host.read", (), (), {"host_reads": 1})
                return out
            return wrapped

        self._wrap(pcg_mod._EarlyRead, "start", start)
        self._wrap(pcg_mod._EarlyRead, "wait", wait)

        probe_src = []

        def mark(kind):
            rec.marks.append((kind, len(rec.ops)))
            if rec.inject_read and kind != "end" and probe_src:
                pcg_mod._read(probe_src[0])

        if self.inject_read:
            import torch

            probe_src.append(rec._quietly(
                torch.zeros, 1, device=self.device_type))
        self._undo.append((pcg_mod, "TRIP_PROBE", pcg_mod.TRIP_PROBE))
        pcg_mod.TRIP_PROBE = mark

    # -- context ---------------------------------------------------------
    def __enter__(self) -> "TripRecorder":
        import contextlib

        import torch

        self._stack = contextlib.ExitStack()
        self._install()
        self._stack.callback(self._uninstall)
        if self.profile:
            self._stack.enter_context(torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]))
        self._stack.enter_context(self._mode())
        return self

    def _uninstall(self) -> None:
        while self._undo:
            owner, attr, orig = self._undo.pop()
            setattr(owner, attr, orig)

    def __exit__(self, *exc) -> None:
        self._stack.close()
        self._keep.clear()

    # -- results ---------------------------------------------------------
    def trips(self) -> List[Trip]:
        """The trip windows between the marks, in order."""
        out = []
        for (kind, i), (_k2, j) in zip(self.marks, self.marks[1:]):
            if kind != "end":
                out.append(Trip(kind, self.ops[i:j]))
        return out

    def totals(self) -> Dict[str, int]:
        return sum_counts(self.ops)


def difference(longer: Dict[str, int], shorter: Dict[str, int]
               ) -> Dict[str, int]:
    return {k: longer[k] - shorter[k] for k in COUNTERS}
