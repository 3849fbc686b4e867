"""Step checkpoints and mid-solve snapshots.

Port of ``pcg_mpi_solver_tpu/utils/checkpoint.py`` (:53-437, :441-671):

* ``ckpt_{t:06d}.npz``: the solver state after COMPLETED step ``t``
  (:class:`CheckpointManager`), plus the atomically published ``latest``
  pointer; a missing or corrupt pointer target falls back to the newest
  valid checkpoint.
* ``snap_{t:06d}.npz``: a mid-solve snapshot INSIDE step ``t``
  (:class:`SnapshotStore`): the chunked engine's resumable state, saved
  every N chunks, so a killed process loses at most N chunks and
  ``solve(resume=True)`` continues with bit-identical history.  Retention
  keeps the newest ``PCG_TPU_SNAP_KEEP`` files (default 2).
* ``many_{t:06d}.npz``: the same for a blocked solve
  (:meth:`SnapshotStore.for_many_solver`, ``solve_many(resume=True)``):
  the blocked carry in the port's (R, P, n_loc) layout, the fingerprint
  extended by the block width, a hash of the block's loads and whether
  the cycle carries the fallback preconditioner.
* ``step_{t:06d}.npz``: the full state of a time history after COMPLETED
  timestep ``t`` (:meth:`SnapshotStore.for_time_solver`: the kinematic
  vectors, the step histories or probe series and frames, the schedule),
  written by ``resilience.engine.TimeHistoryGuard`` for
  ``DynamicsSolver.run`` and ``NewmarkSolver.run``; these records are the
  resume points and outlive their step, under the same retention.

A fingerprint of the model and the solver configuration guards them:
:func:`_fingerprint` has the JAX package's field names, and wherever a
field means the same thing in the port, its value; so the port resumes a
snapshot the JAX package wrote, and refuses one of other numerics.
"""

from __future__ import annotations

import glob as _glob
import hashlib
import json
import os
import threading
import warnings
from typing import Any, Dict, Optional

import numpy as np
import torch


def _model_hash(solver) -> str:
    """Content hash of the model the solver was built from (the JAX
    package's field list and order): a resume against a model of the
    same shapes but other materials, loads or partition must fail."""
    h = hashlib.sha256()
    m = getattr(solver, "_model", None)
    if m is not None:
        for arr in (m.ck, m.cm, m.ce, m.F, m.Ud, m.fixed_dof,
                    m.elem_type, m.elem_dofs_flat, m.elem_sign_flat,
                    m.node_coords):
            a = np.ascontiguousarray(arr)
            h.update(str(a.dtype).encode())
            h.update(a.tobytes())
        for t in sorted(m.elem_lib):
            h.update(np.ascontiguousarray(m.elem_lib[t]["Ke"]).tobytes())
        h.update(json.dumps(m.mat_prop, sort_keys=True,
                            default=repr).encode())
    ep = getattr(solver.pm, "elem_part", None)
    if ep is not None:
        h.update(np.ascontiguousarray(ep).tobytes())
    return h.hexdigest()


def array_hash(arr) -> str:
    """Short content hash of one array (shape, dtype and bytes), the JAX
    package's ``cache.keys.array_hash``: the blocked snapshot's
    ``rhs_hash``."""
    a = np.ascontiguousarray(np.asarray(arr))
    h = hashlib.sha256(f"{a.shape}:{a.dtype}".encode())
    h.update(a.tobytes())
    return h.hexdigest()[:16]


def _np_dtype_name(dtype) -> str:
    return str(torch.empty((), dtype=dtype).numpy().dtype)


def _fingerprint(solver) -> dict:
    """Everything that must not drift between a checkpoint and its
    resume, under the JAX package's field names.  Fields of options the
    port does not run take their one value (``trace_len`` 0, ``n_procs``
    1).  ``matvec_form`` is "gse" on the structured and hybrid backends
    (the port's slab product sums each cell's corner contributions per
    node, the JAX package's default gse form) and "n/a" on the general
    one; ``pallas`` names the float32 kernel variant when a float32 slab
    product runs on the card (mixed, or direct float32), else "off" (the
    plain version on the CPU, and the general operator, have one
    summation order), as the JAX package's ``_effective_kernel``.  The
    hybrid backend's level block dims, level combine (with its dense
    width KD under ``gather``) and float64 refresh reorder sums, so they
    are fields too (``[]``, "n/a", "n/a" and "stencil" on the other
    backends)."""
    cfg = solver.config
    sc = cfg.solver
    th = cfg.time_history
    meta = solver.mg_setup.meta if solver.mg_setup is not None else None
    kernel = ((solver.mixed or solver.dtype == torch.float32)
              and solver.backend in ("structured", "hybrid")
              and solver.device.type == "cuda")
    combine = getattr(solver.ops, "combine", "n/a")
    return {
        "model_hash": _model_hash(solver),
        "glob_n_dof": int(solver.pm.glob_n_dof),
        "n_parts": int(solver.pm.n_parts),
        "n_loc": int(solver.pm.n_loc),
        "dtype": _np_dtype_name(solver.dtype),
        "precision_mode": sc.precision_mode,
        "precond": sc.precond,
        "mg_shape": ([int(meta["levels"]), int(meta["degree"]),
                      [int(v) for v in meta["dims"]]] if meta else "n/a"),
        "pcg_variant": sc.pcg_variant,
        "nrhs": 1,
        "tol": float(sc.tol),
        "max_iter": int(sc.max_iter),
        "dot_dtype": str(np.dtype(sc.dot_dtype)),
        "max_stag_steps": int(sc.max_stag_steps),
        "inner_tol": float(sc.inner_tol),
        "mixed_knobs": [int(sc.mixed_plateau_window),
                        int(sc.mixed_progress_window),
                        float(sc.mixed_progress_ratio),
                        float(sc.mixed_progress_min_gain)],
        "trace_len": 0,
        "n_procs": 1,
        "deltas": [float(d) for d in th.time_step_delta],
        "export": [bool(th.export_flag), int(th.export_frame_rate),
                   [int(f) for f in th.export_frames], th.export_vars],
        "plot": [bool(th.plot_flag), [int(d) for d in th.probe_dofs]],
        "backend": solver.backend,
        "pallas": solver.kernel_variant if kernel else "off",
        "matvec_form": ("gse" if solver.backend in ("structured", "hybrid")
                        else "n/a"),
        "level_dims": [list(d) for d in getattr(solver.ops, "level_dims",
                                                ())],
        "combine": combine,
        "combine_kd": (int(solver.ops.combine_k[0]) if combine == "gather"
                       else "n/a"),
        "f64_refresh": solver.f64_refresh,
    }


def state_dict(solver) -> dict:
    """Everything needed to continue ``solve()`` after a step (the JAX
    package's keys): the solution, the step history and the export
    counters, frame times and probe history."""
    return {
        "un": solver.un.cpu().numpy(),
        "flags": np.asarray(solver.flags, dtype=np.int64),
        "relres": np.asarray(solver.relres, dtype=np.float64),
        "iters": np.asarray(solver.iters, dtype=np.int64),
        "step_times": np.asarray(solver.step_times, dtype=np.float64),
        "export_count": np.int64(solver._export_count),
        "export_times": np.asarray(solver._export_times, dtype=np.float64),
        "export_wall": np.float64(solver._export_wall),
        "probe_u": (np.stack(solver._probe_u) if solver._probe_u
                    else np.zeros((0, 0))),
    }


def load_state_dict(solver, state: dict) -> None:
    solver.un = torch.as_tensor(np.array(state["un"]), dtype=solver.dtype,
                                device=solver.device)
    solver.flags = [int(v) for v in state["flags"]]
    solver.relres = [float(v) for v in state["relres"]]
    solver.iters = [int(v) for v in state["iters"]]
    solver.step_times = [float(v) for v in state["step_times"]]
    solver._export_count = int(state["export_count"])
    solver._export_times = [float(v) for v in state["export_times"]]
    solver._export_wall = float(state.get("export_wall", 0.0))
    probe = np.asarray(state["probe_u"])
    solver._probe_u = [] if probe.size == 0 else [row for row in probe]


def write_atomic(filename: str, write) -> None:
    """Publish ``filename`` atomically: ``write(fileobj)`` streams into a
    per-process, per-thread temporary, then ``os.replace`` (readers only
    ever see complete files; a failed write leaves no temporary)."""
    tmp = f"{filename}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        with open(tmp, "wb") as f:
            write(f)
        os.replace(tmp, filename)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


def _encode_fingerprint(fp: dict) -> np.ndarray:
    return np.frombuffer(json.dumps(fp, sort_keys=True).encode(),
                         dtype=np.uint8).copy()


class CheckpointManager:
    """Writes and reads per-step solver checkpoints under one directory."""

    def __init__(self, path: str):
        self.path = path

    def _ckpt_file(self, t: int) -> str:
        return os.path.join(self.path, f"ckpt_{t:06d}.npz")

    def save(self, solver, t: int) -> str:
        """Checkpoint the solver state after completed step ``t`` and
        point ``latest`` at it."""
        payload = dict(state_dict(solver))
        out = self._ckpt_file(t)
        os.makedirs(self.path, exist_ok=True)
        payload["t"] = np.int64(t)
        payload["fingerprint"] = _encode_fingerprint(_fingerprint(solver))
        write_atomic(out, lambda f: np.savez_compressed(f, **payload))
        ptr = os.path.join(self.path, "latest")
        write_atomic(ptr, lambda f: f.write(os.path.basename(out).encode()))
        return out

    @staticmethod
    def _valid_step(path: str) -> Optional[int]:
        """The step of a readable checkpoint file, else None (a truncated
        or corrupt npz reads as absent)."""
        try:
            with np.load(path) as z:
                return int(z["t"])
        except Exception:                               # noqa: BLE001
            return None

    def latest_step(self) -> Optional[int]:
        """Newest restorable step: the ``latest`` pointer's target when it
        exists and loads, else the newest VALID ``ckpt_*.npz``."""
        candidates = []
        ptr = os.path.join(self.path, "latest")
        ptr_name = None
        if os.path.exists(ptr):
            with open(ptr) as f:
                ptr_name = f.read().strip()
            candidates.append(ptr_name)
        candidates += sorted(
            (os.path.basename(p) for p in
             _glob.glob(os.path.join(self.path, "ckpt_*.npz"))
             if os.path.basename(p) != ptr_name),
            reverse=True)
        for name in candidates:
            p = os.path.join(self.path, name)
            if not os.path.exists(p):
                continue
            t = self._valid_step(p)
            if t is None:
                continue
            if name != ptr_name and ptr_name is not None:
                warnings.warn(
                    f"checkpoint 'latest' pointer references "
                    f"{ptr_name!r} (missing or corrupt); falling back "
                    f"to {name!r}")
            return t
        return None

    def restore(self, solver, t: Optional[int] = None) -> Optional[int]:
        """Load the checkpoint of step ``t`` (default: the latest) into
        ``solver``.  Returns the restored step, or None when there is
        none; raises ValueError on a fingerprint mismatch."""
        if t is None:
            t = self.latest_step()
            if t is None:
                return None
        with np.load(self._ckpt_file(t)) as z:
            saved = json.loads(bytes(z["fingerprint"]).decode())
            want = _fingerprint(solver)
            if saved != want:
                diffs = {k: (saved.get(k), want[k]) for k in want
                         if saved.get(k) != want[k]}
                raise ValueError(
                    f"checkpoint/solver mismatch (saved, current): {diffs}")
            load_state_dict(solver, {k: z[k] for k in z.files
                                     if k not in ("t", "fingerprint")})
        return t


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "/"))
        else:
            out[key] = np.asarray(v)
    return out


def _unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split("/")
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return out


class SnapshotStore:
    """Mid-solve snapshots under the checkpoint directory: one
    ``<prefix>_{t:06d}.npz`` per in-flight step, published atomically and
    guarded by the solver fingerprint.  The payload is a numpy state tree
    (the chunked engine's direct carry or mixed outer state) flattened
    with ``/``-joined keys.  The owning step deletes its record when it
    completes (:meth:`discard`); the time-history store's ``step``
    records are resume points and stay, bounded by :meth:`retention`."""

    def __init__(self, path: str, fingerprint: Optional[dict] = None,
                 prefix: str = "snap"):
        self.path = path
        self.fingerprint = fingerprint
        self.prefix = prefix

    @classmethod
    def for_solver(cls, solver) -> "SnapshotStore":
        return cls(solver.config.checkpoint_path, _fingerprint(solver))

    @classmethod
    def for_many_solver(cls, solver, nrhs: int,
                        rhs_hash: str = "") -> "SnapshotStore":
        """The blocked solve's store (``many_*.npz``): the solver's
        fingerprint with the block width, the load block's content hash
        and ``many_fallback`` (whether the cycle carries the fallback
        preconditioner, ``Solver._many_use_fb``), so a resume at another
        width, of other loads, or into a cycle without the fallback a
        column was moved to, fails naming the field."""
        fp = dict(_fingerprint(solver))
        fp["nrhs"] = int(nrhs)
        fp["rhs_hash"] = str(rhs_hash)
        fp["many_fallback"] = bool(
            getattr(solver, "_many_use_fb", lambda: False)())
        return cls(solver.config.checkpoint_path, fp, prefix="many")

    @classmethod
    def for_time_solver(cls, solver) -> "SnapshotStore":
        """The timestep store of the time-history drivers: the same
        fingerprint guard, the ``step_*.npz`` namespace, so a quasi-static
        mid-solve snapshot in the same directory is never taken for a
        completed-timestep state."""
        return cls(solver.config.checkpoint_path, _fingerprint(solver),
                   prefix="step")

    def _file(self, t: int) -> str:
        return os.path.join(self.path, f"{self.prefix}_{t:06d}.npz")

    @staticmethod
    def retention() -> int:
        """Keep the newest K files of a prefix (``PCG_TPU_SNAP_KEEP``,
        default 2); a malformed value keeps the default."""
        raw = os.environ.get("PCG_TPU_SNAP_KEEP", "").strip()
        if not raw:
            return 2
        try:
            k = int(raw)
        except ValueError:
            warnings.warn(f"PCG_TPU_SNAP_KEEP={raw!r} is not an integer; "
                          "keeping the default 2 snapshots")
            return 2
        return max(k, 1)

    def _prune(self) -> None:
        """Drop all but the newest K records of this prefix (after a
        successful publish, so the newest is always complete)."""
        files = sorted(
            p for p in _glob.glob(
                os.path.join(self.path, f"{self.prefix}_*.npz"))
            if os.path.basename(p)[len(self.prefix) + 1:-4].isdigit())
        for p in files[:-self.retention()]:
            try:
                os.remove(p)
            except OSError:
                pass

    def latest(self) -> Optional[int]:
        """Newest restorable step of this prefix, or None; a corrupt
        newest file reads as absent."""
        steps = []
        for p in _glob.glob(os.path.join(self.path,
                                         f"{self.prefix}_*.npz")):
            stem = os.path.basename(p)[len(self.prefix) + 1:-4]
            if stem.isdigit():
                steps.append(int(stem))
        for t in sorted(steps, reverse=True):
            try:
                with np.load(self._file(t)) as z:
                    if "__t" in z.files:
                        return t
            except Exception:                           # noqa: BLE001
                continue
        return None

    def save(self, t: int, state: Dict[str, Any]) -> str:
        """Persist the host numpy state tree of in-flight step ``t``."""
        out = self._file(t)
        os.makedirs(self.path, exist_ok=True)
        flat = _flatten(state)
        flat["__t"] = np.int64(t)
        flat["__fingerprint"] = _encode_fingerprint(self.fingerprint or {})
        write_atomic(out, lambda f: np.savez_compressed(f, **flat))
        self._prune()
        return out

    def load(self, t: int) -> Optional[Dict[str, Any]]:
        """The state tree snapshotted inside step ``t``, or None.  Raises
        ValueError on a fingerprint mismatch; a corrupt or truncated
        snapshot reads as absent (the step restarts from its start
        state)."""
        path = self._file(t)
        if not os.path.exists(path):
            return None
        try:
            with np.load(path) as z:
                flat = {k: z[k] for k in z.files}
            saved = json.loads(bytes(flat.pop("__fingerprint")).decode())
        except Exception as e:                          # noqa: BLE001
            warnings.warn(f"mid-solve snapshot {path} unreadable "
                          f"({type(e).__name__}: {e}); restarting the "
                          "step from its start state")
            return None
        flat.pop("__t", None)
        if self.fingerprint is not None and \
                "many_fallback" in self.fingerprint:
            # a blocked record older than the field came from a cycle
            # without the fallback operand (the JAX package's default)
            saved.setdefault("many_fallback", False)
        if self.fingerprint is not None and saved != self.fingerprint:
            diffs = {k: (saved.get(k), self.fingerprint[k])
                     for k in self.fingerprint
                     if saved.get(k) != self.fingerprint[k]}
            raise ValueError(
                f"mid-solve snapshot/solver mismatch (saved, current): "
                f"{diffs}")
        return _unflatten(flat)

    def discard(self, t: int) -> None:
        try:
            os.remove(self._file(t))
        except OSError:
            pass
