"""Explicit elasto-dynamics: central-difference time integration.

Port of ``pcg_mpi_solver_tpu/solver/dynamics.py``.  Lumped mass M and
mass-proportional damping c_m:

    a_n = M^-1 (Fext(t_n) - K u_n) - c_m v_n
    v_{n+1/2} = v_{n-1/2} + dt a_n
    u_{n+1}  = u_n + dt v_{n+1/2}

with the Dirichlet dofs driven as u = Ud * delta(t), v = Vd * delta(t).
K u_n is the backend's matvec (``solver/backends.py``: the general
operator, or the hybrid level grids with one slab kernel launch a level).

The JAX package runs a chunk of steps as one ``lax.scan``; here a chunk is
a host loop of torch ops that reads nothing back: each step's probe
samples go through the owner mask into a preallocated (k, n_probe) device
tensor, and the chunk ends in ONE read, of the samples and the state's
finiteness together.  Chunks end where the host must act (export frames,
snapshot cadence, the next step fault, the end of the schedule).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from pcg_mpi_solver_tpu_torch.config import RunConfig
from pcg_mpi_solver_tpu_torch.models.model_data import ModelData
from pcg_mpi_solver_tpu_torch.obs.flight import attach_flight
from pcg_mpi_solver_tpu_torch.obs.metrics import MetricsRecorder
from pcg_mpi_solver_tpu_torch.ops.structured_matvec import (
    VARIANTS, pallas_planes, selected_variant)
from pcg_mpi_solver_tpu_torch.parallel.distributed import (
    gather_owned_global, make_global_mesh)
from pcg_mpi_solver_tpu_torch.resilience import (
    FaultPlan, TimeHistoryGuard, kinematic_state_io)
from pcg_mpi_solver_tpu_torch.solver.backends import select_time_backend
from pcg_mpi_solver_tpu_torch.solver.driver import (
    _DTYPES, check_slice, resolve_device)
from pcg_mpi_solver_tpu_torch.utils.checkpoint import SnapshotStore
from pcg_mpi_solver_tpu_torch.validate import run_preflight


def stable_dt(model: ModelData, safety: float = 0.9) -> float:
    """CFL estimate: h_min / c_d with c_d = sqrt(E_max / rho_min), the
    dilatational wave speed (conservative for hex elements)."""
    E = np.array([m["E"] for m in model.mat_prop], dtype=float)
    rho = np.array([m.get("Rho", 1.0) for m in model.mat_prop], dtype=float)
    c = float(np.sqrt((E / rho).max()))
    # ck = E * h, ce = 1 / h  =>  h = 1 / ce
    h_min = float((1.0 / model.ce).min())
    return safety * h_min / c


@dataclasses.dataclass
class DynamicsResult:
    u: np.ndarray                 # final global displacement (n_dof,)
    probe_t: np.ndarray           # (n_steps,)
    probe_u: np.ndarray           # (n_probe, n_steps)
    frames: List[np.ndarray]      # exported global displacement frames
    frame_times: List[float]


class DynamicsSolver:
    """Explicit central-difference solver on the partitioned model, on the
    card unless ``device="cpu"``.  The storage dtype is
    ``config.solver.dtype`` (float64 by default); float32 on the hybrid
    backend runs the level batches through the kernel
    ``PCG_TPU_PALLAS_V`` selects, read once here."""

    def __init__(self, model: ModelData, config: Optional[RunConfig] = None,
                 n_parts: Optional[int] = None, dt: Optional[float] = None,
                 damping: float = 0.0, probe_dofs: Sequence[int] = (),
                 backend: str = "auto",
                 recorder: Optional[MetricsRecorder] = None, device=None,
                 mesh=None):
        self.config = config or RunConfig()
        # telemetry and the flight recorder, wired as Solver's
        self.recorder = recorder if recorder is not None \
            else MetricsRecorder.default(
                jsonl_path=self.config.telemetry_path or None,
                profile=True if self.config.telemetry_profile else None)
        self._rec = self.recorder
        attach_flight(self._rec, self.config.flight_path, "dynamics")
        self._model = model              # the checkpoint fingerprint's
        # the process group's parts mesh, as Solver's
        self.mesh = mesh if mesh is not None else make_global_mesh()
        self.device = resolve_device(device if device is not None
                                     else self.mesh.device)
        check_slice(self.config)
        n_parts = self.config.n_parts if n_parts is None else n_parts
        if n_parts < 1:
            raise ValueError(f"n_parts must be >= 1, got {n_parts}")
        self._part_range = self.mesh.part_range(n_parts)
        dt_source = ("arg" if dt is not None else
                     "model" if model.dt and model.dt > 0 else "cfl")
        self.dt = float(dt if dt is not None else
                        (model.dt if model.dt and model.dt > 0 else
                         stable_dt(model)))
        self.damping = float(damping)
        # an explicit caller dt above the CFL bound fails here; a model
        # file's dt only warns (in the preflight event)
        run_preflight(model, self.config, recorder=self._rec,
                      context={"kind": "dynamics", "dt": self.dt,
                               "dt_source": dt_source})
        self.dtype = _DTYPES[self.config.solver.dtype]
        # the checkpoint fingerprint's fields: no mixed shadow, no mg, no
        # refresh operator
        self.mixed = False
        self.mg_setup = None
        self.f64_refresh = "stencil"
        self.kernel_variant = selected_variant()
        self.kernel_planes = (pallas_planes()
                              if VARIANTS[self.kernel_variant][1] else None)
        t_part = time.perf_counter()
        self.backend, self.pm, mk_ops, mk_data = select_time_backend(
            model, n_parts, partition_method=self.config.partition_method,
            device=self.device, backend=backend,
            kernel=dict(variant=self.kernel_variant,
                        planes=self.kernel_planes), mesh=self.mesh)
        # seconds building the partition (no cache here, as in the JAX
        # package: every build is cold, as Solver counts its cold builds)
        self.partition_build_s = time.perf_counter() - t_part
        t_up = time.perf_counter()
        pm = self.pm
        self.ops = mk_ops(self.dtype)
        data = mk_data(self.dtype)

        def put(a, dt):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                                   device=self.device)

        # the assembled lumped mass, sliced per part (zero-mass dofs get
        # 0); this rank's rows across processes
        rows = slice(*self._part_range)
        data["inv_M"] = put(np.where(pm.inv_diag_M > 0, pm.inv_diag_M,
                                     0.0)[rows], self.dtype)
        gid = pm.dof_gid
        data["Vd"] = put(np.where(gid >= 0, model.Vd[np.maximum(gid, 0)],
                                  0.0)[rows], self.dtype)
        # probe maps: the local index of each probe dof on the one part
        # that owns it, and the owner mask
        self._probe = np.asarray(probe_dofs, dtype=np.int64)
        n_pcols = max(len(self._probe), 1)
        pidx = np.zeros((pm.n_parts, n_pcols), dtype=np.int64)
        pmask = np.zeros((pm.n_parts, n_pcols))
        for j, d in enumerate(self._probe):
            hits = np.argwhere((gid == d) & (pm.weight > 0))
            if len(hits) == 0:
                raise ValueError(
                    f"probe dof {int(d)} is not an owned dof of any part "
                    "(out of range or Dirichlet-constrained everywhere)")
            p, i = hits[0]
            pidx[p, j], pmask[p, j] = i, 1.0
        data["probe_idx"] = put(pidx[rows], torch.int64)
        data["probe_mask"] = put(pmask[rows], self.dtype)
        data["fix"] = 1.0 - data["eff"]
        self.data = data
        self.u = torch.zeros((rows.stop - rows.start, pm.n_loc),
                             dtype=self.dtype, device=self.device)
        self.v = torch.zeros_like(self.u)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.upload_s = time.perf_counter() - t_up
        # settable: tests inject programmatically, PCG_TPU_FAULTS drives
        # drills (the step domain, ``kill@s:N``)
        self.fault_plan = FaultPlan.from_env(recorder=self._rec)
        # the chunks of the last run(), one host read each
        self.chunks = 0

    def _chunk(self, u, v, deltas):
        """Integrate ``len(deltas)`` steps from (u, v) with no host read:
        returns (u, v, one host array of the (k, n_probe) samples followed
        by the state's finiteness flag), that array being the chunk's one
        read."""
        d = self.data
        eff, fix = d["eff"], d["fix"]
        dt, cm = self.dt, self.damping
        probe = torch.empty((len(deltas), d["probe_idx"].shape[1]),
                            dtype=self.dtype, device=self.device)
        for i, delta in enumerate(deltas):
            fint = self.ops.matvec(d, u)
            # mass damping: C = c_m M  =>  M^-1 C v = c_m v
            a = d["inv_M"] * (d["F"] * delta - fint) - cm * v
            v2 = v + dt * a
            u2 = u + dt * v2
            # Dirichlet driving
            u = eff * u2 + fix * d["Ud"] * delta
            v = eff * v2 + fix * d["Vd"] * delta
            # owner-masked probe sample
            torch.sum(torch.gather(u, 1, d["probe_idx"]) * d["probe_mask"],
                      dim=0, out=probe[i])
        ok = torch.isfinite(u).all().to(self.dtype).reshape(1)
        out = torch.cat([probe.reshape(-1), ok])
        if self.ops.multi:
            # each probe is owned by one rank: the sum is its value; the
            # state is finite when every rank's is
            out = self.ops._psum(out).cpu().numpy()
            out[-1] = float(out[-1] == self.mesh.world)
            return u, v, out
        return u, v, out.cpu().numpy()

    def _make_guard(self, resume: bool) -> Optional[TimeHistoryGuard]:
        """The timestep-granular harness: ``config.snapshot_every``
        snapshots of the full state (u, v, probe series, frames) into
        ``step_*.npz``, step faults, NaN/Inf rollback within
        ``config.solver.max_recoveries``."""
        every = int(self.config.snapshot_every)
        plan = self.fault_plan
        if every <= 0 and plan is None and not resume:
            return None
        store = (SnapshotStore.for_time_solver(self)
                 if every > 0 or resume else None)
        fetch, put = kinematic_state_io(self.device, self.dtype, ("u", "v"),
                                        mesh=self.mesh)
        return TimeHistoryGuard(
            store=store, snapshot_every=every, fetch_state=fetch,
            put_state=put, recorder=self._rec, faults=plan,
            max_recoveries=int(self.config.solver.max_recoveries))

    @staticmethod
    def _next_chunk(done: int, n_steps: int, export_every: int,
                    guard) -> int:
        """Steps of the next chunk: up to the nearest host boundary (export
        frame, snapshot cadence, pending step fault, end of schedule)."""
        cands = [n_steps]
        if export_every > 0:
            cands.append(done + export_every - done % export_every)
        if guard is not None:
            if guard.snapshot_every > 0:
                cands.append(done + guard.snapshot_every
                             - done % guard.snapshot_every)
            if guard.faults is not None:
                nf = guard.faults.next_step_fault(done)
                if nf is not None:
                    cands.append(nf)
        return min(c for c in cands if c > done) - done

    def run(self, n_steps: int, load_factor=None, export_every: int = 0,
            resume: bool = False) -> DynamicsResult:
        """Integrate ``n_steps``.  ``load_factor``: a scalar, an (n_steps,)
        array, or None (1.0).  ``export_every``: a displacement frame every
        k steps (and at the end).

        With ``config.snapshot_every > 0`` the full state is checkpointed
        every N completed timesteps (``step_*.npz``, retention
        ``PCG_TPU_SNAP_KEEP``); ``resume=True`` restores the newest one and
        continues mid-history with bit-identical probe series and frames.
        A non-finite state found at a chunk's end rolls back to the last
        snapshot (within ``config.solver.max_recoveries``), or raises
        ``FloatingPointError`` when there is none."""
        if load_factor is None:
            deltas = np.ones(n_steps)
        else:
            deltas = np.broadcast_to(np.asarray(load_factor, dtype=float),
                                     (n_steps,)).copy()
        guard = self._make_guard(resume)
        frames: List[np.ndarray] = []
        frame_steps: List[int] = []
        n_pcols = max(len(self._probe), 1)
        # per-chunk probe arrays, concatenated when needed (a concat of
        # the growing history each chunk would be quadratic)
        probe_chunks: List[np.ndarray] = []

        def _probe_cat() -> np.ndarray:
            return (np.concatenate(probe_chunks, axis=0) if probe_chunks
                    else np.zeros((0, n_pcols)))

        done = 0
        u, v = self.u, self.v
        self.chunks = 0
        if resume and guard is not None:
            got = guard.load_resume()
            if got is not None:
                t0, st = got
                if not np.array_equal(np.asarray(st["deltas"])[:t0],
                                      deltas[:t0]):
                    raise ValueError(
                        "resume schedule mismatch: the snapshot was "
                        "written under a different load_factor prefix")
                u, v = st["u"], st["v"]
                done = int(t0)
                probe_chunks = [np.asarray(st["probe"])[:done]]
                frames = [f.copy() for f in np.asarray(st["frames"])]
                frame_steps = [int(s) for s in
                               np.asarray(st["frame_steps"])]
        while done < n_steps:
            k = self._next_chunk(done, n_steps, export_every, guard)
            t0c = time.perf_counter()
            with self._rec.dispatch("dynamics_chunk", emit=False):
                u2, v2, out = self._chunk(
                    u, v, [float(x) for x in deltas[done:done + k]])
            self.chunks += 1
            self._rec.event("dynamics_chunk", steps=int(k),
                            wall_s=round(time.perf_counter() - t0c, 6))
            pr = out[:-1].reshape(k, n_pcols)
            # an explicit run has no flags or residuals: poison would
            # otherwise integrate silently to the end
            if not (out[-1] == 1 and np.isfinite(pr).all()):
                if guard is None:
                    raise FloatingPointError(
                        f"non-finite state within dynamics steps "
                        f"{done + 1}..{done + k} (dt={self.dt:.3e}; check "
                        "against stable_dt(); set snapshot_every for "
                        "rollback)")
                t_roll, st = guard.rollback(done + k)
                u, v = st["u"], st["v"]
                done = int(t_roll)
                probe_chunks = [_probe_cat()[:done]]
                n_keep = sum(1 for s in frame_steps if s <= done)
                frames, frame_steps = frames[:n_keep], frame_steps[:n_keep]
                continue
            u, v = u2, v2
            done += k
            if len(self._probe):
                probe_chunks.append(pr)
            if export_every > 0 and (done % export_every == 0
                                     or done == n_steps):
                frames.append(gather_owned_global(self.pm, u, self.mesh))
                frame_steps.append(done)
            if guard is not None:
                st = guard.boundary(done, lambda: {
                    "u": u, "v": v, "t": np.int64(done),
                    "probe": _probe_cat(),
                    "frames": (np.stack(frames) if frames
                               else np.zeros((0, self._model.n_dof))),
                    "frame_steps": np.asarray(frame_steps, np.int64),
                    "deltas": deltas})
                if st is not None:
                    u, v = st["u"], st["v"]
        self.u, self.v = u, v
        self._rec.emit_run_summary()
        probe_u = (_probe_cat().T[:len(self._probe)] if len(self._probe)
                   else np.zeros((0, n_steps)))
        return DynamicsResult(
            u=gather_owned_global(self.pm, u, self.mesh),
            probe_t=(np.arange(n_steps) + 1) * self.dt,
            probe_u=probe_u, frames=frames,
            frame_times=[s * self.dt for s in frame_steps])
