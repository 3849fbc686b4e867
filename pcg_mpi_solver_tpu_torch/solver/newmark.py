"""Implicit elasto-dynamics: Newmark-beta time integration with a PCG
solve per step.

Port of ``pcg_mpi_solver_tpu/solver/newmark.py``.  a-form, lumped mass M,
mass-proportional damping C = c_m M:

    A u_{n+1} = F(t_{n+1}) + M (a0 u_n + a2 v_n + a3 w_n)
                           + C (a1 u_n + a4 v_n + a5 w_n)
    w_{n+1}   = a0 (u_{n+1} - u_n) - a2 v_n - a3 w_n
    v_{n+1}   = v_n + dt ((1 - gamma) w_n + gamma w_{n+1})

with A = K + a0 M + a1 C, a0 = 1/(beta dt^2), a1 = gamma/(beta dt),
a2 = 1/(beta dt), a3 = 1/(2 beta) - 1, a4 = gamma/beta - 1,
a5 = dt (gamma/(2 beta) - 1) (w is the acceleration).  The default
beta = 1/4, gamma = 1/2 (average acceleration) is unconditionally stable:
dt is a resolution choice, not a CFL bound.

M is lumped and assembled, so A is the backend's K matvec plus an
elementwise term (:class:`MassShiftedOps`); its Jacobi diagonal and 3x3
node blocks shift the same way, so every preconditioner, the mixed shell
and the chunked path (``solver/chunked.py`` with the recovery ladder of
``resilience/engine.run_with_recovery``, taken at 4 M dofs and above as
in the JAX package) run on it unchanged.  A is constant over the run:
the preconditioner is built once, on the device.
"""

from __future__ import annotations

import dataclasses
import math
import time
import warnings
from typing import List, Optional, Sequence

import numpy as np
import torch

from pcg_mpi_solver_tpu_torch.config import RunConfig
from pcg_mpi_solver_tpu_torch.models.model_data import ModelData
from pcg_mpi_solver_tpu_torch.obs.flight import attach_flight
from pcg_mpi_solver_tpu_torch.obs.metrics import MetricsRecorder
from pcg_mpi_solver_tpu_torch.obs.trace import (
    ConvergenceTrace, clamp_trace_len, empty_trace, trace_init,
    unpack_trace)
from pcg_mpi_solver_tpu_torch.ops import mg as mgmod
from pcg_mpi_solver_tpu_torch.ops.matvec import Ops
from pcg_mpi_solver_tpu_torch.ops.precond import invert_node_blocks
from pcg_mpi_solver_tpu_torch.ops.structured_matvec import (
    VARIANTS, pallas_planes, selected_variant)
from pcg_mpi_solver_tpu_torch.resilience import (
    DispatchGuard, FaultPlan, RecoveryHooks, ResilienceContext,
    TimeHistoryGuard, kinematic_state_io, retry_deadline_s,
    run_with_recovery)
from pcg_mpi_solver_tpu_torch.solver.backends import select_time_backend
from pcg_mpi_solver_tpu_torch.solver.chunked import (
    ChunkedEngine, auto_dispatch_cap)
from pcg_mpi_solver_tpu_torch.solver.driver import (
    _DTYPES, LadderPieces, StepResult, check_slice, owned_global,
    resolve_device)
from pcg_mpi_solver_tpu_torch.solver.pcg import (
    _np_type, _read, cold_carry, pcg, pcg_mixed)
from pcg_mpi_solver_tpu_torch.utils.checkpoint import SnapshotStore
from pcg_mpi_solver_tpu_torch.validate import run_preflight


@dataclasses.dataclass(frozen=True)
class MassShiftedOps:
    """A = K + c M over any backend's ops: ``matvec``, ``diag``,
    ``node_block_diag``, ``block_precond`` and ``apply_prec`` carry the
    (assembled, diagonal) mass term; everything else delegates."""

    base: Ops
    c: float

    def matvec(self, data, x):
        return self.base.matvec(data, x) + self.c * data["diag_M"] * x

    def matvec_local(self, data, x):
        # diag_M holds ASSEMBLED values on every copy of a shared dof: the
        # shift rides the assembled product only; a partial sum plus the
        # full mass term would count it twice after assembly
        raise NotImplementedError("MassShiftedOps only exposes the "
                                  "assembled matvec")

    def diag_local(self, data):
        raise NotImplementedError("MassShiftedOps only exposes the "
                                  "assembled diag")

    def _node_block_local(self, data):
        raise NotImplementedError("MassShiftedOps only exposes the "
                                  "assembled node_block_diag")

    def diag(self, data):
        return self.base.diag(data) + self.c * data["diag_M"]

    def node_block_diag(self, data):
        B = self.base.node_block_diag(data)
        m3 = self.base._as_node3(self.c * data["diag_M"])
        return B + m3[..., :, None] * torch.eye(3, dtype=B.dtype,
                                                device=B.device)

    def block_precond(self, data):
        return invert_node_blocks(self.node_block_diag(data),
                                  self.base._as_node3(data["eff"]))

    def apply_prec(self, m, r, data=None):
        # the mg V-cycle runs on THIS (shifted) operator: delegating would
        # bind its smoothing matvecs to K instead of A
        if isinstance(m, dict):
            return mgmod.mg_apply(self, data, m, r)
        return self.base.apply_prec(m, r, data)

    def __getattr__(self, name):
        if name in ("base", "c") or name.startswith("__"):
            raise AttributeError(name)
        return getattr(self.base, name)


class NewmarkSolver(LadderPieces):
    """Implicit Newmark-beta on the partitioned model, on the card unless
    ``device="cpu"``.  The backend choice is ``select_time_backend``'s
    (general, or hybrid for octree models when asked for); precision,
    preconditioner and variant come from ``config.solver`` as in
    ``Solver``; mg runs on the general backend only."""

    def __init__(self, model: ModelData, config: Optional[RunConfig] = None,
                 n_parts: Optional[int] = None, dt: float = 1.0,
                 beta: float = 0.25, gamma: float = 0.5,
                 damping: float = 0.0, backend: str = "auto",
                 recorder: Optional[MetricsRecorder] = None, device=None):
        self.config = config or RunConfig()
        sc = self.config.solver
        # telemetry and the flight recorder, wired as Solver's
        self.recorder = recorder if recorder is not None \
            else MetricsRecorder.default(
                jsonl_path=self.config.telemetry_path or None,
                profile=True if self.config.telemetry_profile else None)
        self._rec = self.recorder
        attach_flight(self._rec, self.config.flight_path, "newmark",
                      pcg_variant=sc.pcg_variant, precond=sc.precond)
        self._model = model              # the checkpoint fingerprint's
        self.device = resolve_device(device)
        check_slice(self.config)
        n_parts = self.config.n_parts if n_parts is None else n_parts
        if n_parts < 1:
            raise ValueError(f"n_parts must be >= 1, got {n_parts}")
        run_preflight(model, self.config, recorder=self._rec,
                      context={"kind": "newmark"})
        if beta <= 0:
            raise ValueError("NewmarkSolver requires beta > 0 (beta == 0 is "
                             "the explicit path: solver/dynamics.py)")
        if dt <= 0:
            raise ValueError(f"NewmarkSolver requires dt > 0, got {dt}")
        if gamma <= 0:
            raise ValueError(f"NewmarkSolver requires gamma > 0, got {gamma}")
        if gamma < 0.5:
            # negative algorithmic damping: each step returns flag 0 while
            # the integration grows without bound
            warnings.warn(
                f"Newmark gamma={gamma} < 0.5 is numerically unstable "
                "(negative algorithmic damping); unconditional stability "
                "requires gamma >= 1/2 with beta >= gamma/2", stacklevel=2)
        elif 2.0 * beta < gamma:
            warnings.warn(
                f"Newmark beta={beta} < gamma/2={gamma / 2}: only "
                "conditionally stable — the integration diverges for dt "
                "above the stability bound while each step reports flag=0",
                stacklevel=2)
        self.dt, self.beta, self.gamma = float(dt), float(beta), float(gamma)
        self.damping = float(damping)
        self.mixed = sc.precision_mode == "mixed"
        self.dtype = torch.float64 if self.mixed else _DTYPES[sc.dtype]
        dot_dtype = _DTYPES[sc.dot_dtype]
        self.f64_refresh = "stencil"     # A's own float64 matvec refreshes
        self.kernel_variant = selected_variant()
        self.kernel_planes = (pallas_planes()
                              if VARIANTS[self.kernel_variant][1] else None)
        kernel = dict(variant=self.kernel_variant, planes=self.kernel_planes)
        mg_degree = int(sc.mg_smooth_degree)

        t_part = time.perf_counter()
        self.backend, self.pm, mk_ops, mk_data = select_time_backend(
            model, n_parts, partition_method=self.config.partition_method,
            device=self.device, backend=backend, kernel=kernel,
            mg_degree=mg_degree)
        # seconds building the partition (no cache here, as in the JAX
        # package: every build is cold, as Solver counts its cold builds)
        self.partition_build_s = time.perf_counter() - t_part
        if sc.precond == "mg" and self.backend != "general":
            raise ValueError(
                "precond='mg' on the Newmark path is supported on the "
                "general backend only; use backend='general' or "
                "precond='jacobi'|'block3'")
        pm = self.pm
        t_up = time.perf_counter()
        data = mk_data(self.dtype)
        # the a-form coefficients
        dt_, b, g = self.dt, self.beta, self.gamma
        self.a0 = 1.0 / (b * dt_ * dt_)
        self.a1 = g / (b * dt_)
        self.a2 = 1.0 / (b * dt_)
        self.a3 = 1.0 / (2.0 * b) - 1.0
        self.a4 = g / b - 1.0
        self.a5 = dt_ * (g / (2.0 * b) - 1.0)
        cshift = self.a0 + self.a1 * self.damping
        self.base_ops = mk_ops(dot_dtype)
        self.ops = MassShiftedOps(self.base_ops, cshift)
        # the assembled lumped mass on every copy of a dof (zero-mass dofs
        # stay 0: A = K there, still SPD) and the prescribed velocity
        gid = pm.dof_gid

        def local(v):
            return torch.as_tensor(
                np.where(gid >= 0, v[np.maximum(gid, 0)], 0.0),
                dtype=self.dtype, device=self.device)

        data["diag_M"] = local(model.diag_M)
        data["Vd"] = local(model.Vd)
        data["fix"] = 1.0 - data["eff"]
        self.mg_setup = None
        if sc.precond == "mg":
            t_mg = time.perf_counter()
            self.mg_setup = mgmod.build_mg_host(
                model, pm, n_levels=int(sc.mg_levels), degree=mg_degree,
                max_replicated_dofs=int(sc.mg_max_replicated_dofs))
            data["mg"] = mgmod.tree_from_numpy(self.mg_setup.tree,
                                               self.dtype, self.device)
            self.mg_setup_s = time.perf_counter() - t_mg
        self.data = data
        if self.mixed:
            # the f32 inner cycles' tree (diag_M, Vd and the mg tree cast)
            self.data32 = mgmod.cast_tree(data, torch.float32)
            self.ops32 = MassShiftedOps(mk_ops(torch.float32), cshift)
        if self.mg_setup is not None:
            # the fine Chebyshev bound of the SHIFTED operator (no
            # partition cache on the time solvers, as in the JAX package)
            t_lam = time.perf_counter()
            lam_fine = mgmod.estimate_fine_lam(self.ops, self.data)
            self.mg_lam_s = time.perf_counter() - t_lam
            self.mg_lam = mgmod.install_lam_and_report(
                self.mg_setup, lam_fine,
                trees=[self.data] + ([self.data32] if self.mixed else []),
                recorder=self._rec, wall_s=self.mg_setup_s + self.mg_lam_s,
                cached=False)
        self.u = torch.zeros((pm.n_parts, pm.n_loc), dtype=self.dtype,
                             device=self.device)
        self.v = torch.zeros_like(self.u)
        self.w = torch.zeros_like(self.u)
        # A is constant over the run: its preconditioner is built once
        self._prec = self._make_prec(sc.precond)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.upload_s = time.perf_counter() - t_up

        # the convergence ring (trace_resid), as Solver's
        self.trace_len = (clamp_trace_len(sc.trace_resid, sc.max_iter)
                          if sc.trace_resid > 0 else 0)
        self._trace_dtype = torch.float32 if self.mixed else dot_dtype
        self.last_trace: Optional[ConvergenceTrace] = None
        self._ring = None
        # the chunked path at the JAX package's auto cap (4 M dofs)
        self._dispatch_cap = auto_dispatch_cap(
            sc, pm.glob_n_dof, pm.n_loc * pm.n_parts)
        self.dispatch_log: List[tuple] = []
        self._engine = None
        if self._dispatch_cap > 0:
            self._engine = ChunkedEngine(
                ops=self.ops, scfg=sc, glob_n_dof_eff=pm.glob_n_dof_eff,
                cap=self._dispatch_cap, mixed=self.mixed,
                ops32=self.ops32 if self.mixed else None,
                recorder=self._rec, log=self.dispatch_log,
                trace_len=self.trace_len, trace_dtype=self._trace_dtype)
        self._esc_engine = None
        # settable: tests inject programmatically, PCG_TPU_FAULTS drives
        # drills (the step domain too, ``kill@s:N``)
        self.fault_plan = FaultPlan.from_env(recorder=self._rec)
        self.flags: List[int] = []
        self.relres: List[float] = []
        self.iters: List[int] = []

    # -- the stepping pieces ---------------------------------------------
    def _effective_force(self, delta: float):
        """The history term and the Dirichlet lifting at t_{n+1}:
        (u_d = fix * Ud * delta, Fext = eff * (F delta + hist - A u_d))."""
        d = self.data
        u, v, w = self.u, self.v, self.w
        hist = d["diag_M"] * ((self.a0 * u + self.a2 * v + self.a3 * w)
                              + self.damping * (self.a1 * u + self.a4 * v
                                                + self.a5 * w))
        rhs = d["F"] * delta + hist
        udi = d["fix"] * d["Ud"] * delta
        fext = d["eff"] * (rhs - self.ops.matvec(d, udi))
        return udi, fext

    def _kinematics(self, x, udi, delta: float) -> None:
        """u, v, w from the solved increment; on fixed dofs u carries the
        prescribed motion, so w is its consistent acceleration."""
        d = self.data
        u, v, w = self.u, self.v, self.w
        g = self.gamma
        u2 = x + udi
        w2 = self.a0 * (u2 - u) - self.a2 * v - self.a3 * w
        v2 = v + self.dt * ((1.0 - g) * w + g * w2)
        v2 = d["eff"] * v2 + d["fix"] * d["Vd"] * delta
        self.u, self.v, self.w = u2, v2, w2

    def _init_accel(self, delta0: float) -> torch.Tensor:
        """w = M^-1 (F delta0 - K u - C v) at the current state, on the
        unshifted K (lumped M: one matvec, an elementwise solve)."""
        d = self.data
        M = d["diag_M"]
        one = torch.ones((), dtype=M.dtype, device=M.device)
        inv_m = torch.where(M > 0, 1.0 / torch.where(M > 0, M, one),
                            torch.zeros_like(one))
        fint = self.base_ops.matvec(d, self.u)
        return d["eff"] * (inv_m * (d["F"] * delta0 - fint)
                           - self.damping * self.v)

    def _step_oneshot(self, delta: float):
        sc = self.config.solver
        udi, fext = self._effective_force(delta)
        x0 = self.data["eff"] * self.u
        glob_n_eff = self.pm.glob_n_dof_eff
        ring = (trace_init(self.trace_len, self._trace_dtype)
                if self.trace_len else None)
        self._ring = ring
        if self.mixed:
            res = pcg_mixed(
                self.ops32, self.data32, self.ops, self.data, fext, x0,
                self._prec, tol=sc.tol, max_iter=sc.max_iter,
                glob_n_dof_eff=glob_n_eff, max_stag_steps=sc.max_stag_steps,
                inner_tol=sc.inner_tol, variant=sc.pcg_variant,
                trace_in=ring)
        else:
            res = pcg(self.ops, self.data, fext, x0, self._prec,
                      tol=sc.tol, max_iter=sc.max_iter,
                      glob_n_dof_eff=glob_n_eff,
                      max_stag_steps=sc.max_stag_steps,
                      variant=sc.pcg_variant, trace_in=ring)
        self._kinematics(res.x, udi, delta)
        return res.flag, res.relres, res.iters

    def _step_chunked(self, delta: float):
        """The chunked step: the start (history term, lifting, r0, ||b||),
        then ``run_with_recovery`` over the engine on A (restart from the
        min-residual iterate, the scalar-Jacobi fallback of A, f64
        escalation)."""
        rec = self._rec
        sc = self.config.solver
        data64 = self.data
        w = data64["weight"] * data64["eff"]
        f = _np_type(self.ops.dot_dtype)
        del self.dispatch_log[:]
        with rec.dispatch("start"):
            udi, fext = self._effective_force(delta)
            x0 = data64["eff"] * self.u
            r0 = fext - data64["eff"] * self.ops.matvec(data64, x0)
            v = _read(self.ops.wdot(w, fext, fext), self.ops.wdot(w, r0, r0))
            n2b, normr0 = np.sqrt(f(v[0])), np.sqrt(f(v[1]))
            carry = cold_carry(x0, r0, normr0, self.ops.dot_dtype,
                               variant=sc.pcg_variant)
        if n2b == 0:
            x_fin, flag, relres, total = torch.zeros_like(x0), 0, 0.0, 0
        else:
            def restart(x):
                # a cold Krylov carry at the best iterate seen
                with rec.dispatch("restart"):
                    r = fext - data64["eff"] * self.ops.matvec(data64, x)
                    nr = np.sqrt(f(_read(self.ops.wdot(w, r, r))[0]))
                return cold_carry(x, r, nr, self.ops.dot_dtype,
                                  variant=sc.pcg_variant), nr

            def cold_restart():
                # device loss: the step's cold start state (x0, r0 and the
                # constant preconditioner are intact)
                with rec.dispatch("start"):
                    c = cold_carry(x0, r0, normr0, self.ops.dot_dtype,
                                   variant=sc.pcg_variant)
                return c, normr0, self._prec

            data = ({"f64": self.data, "f32": self.data32} if self.mixed
                    else self.data)
            eng, x_fin, flag, relres, total = run_with_recovery(
                self._engine, data, fext, carry, normr0, n2b, self._prec,
                scfg=sc, mixed=self.mixed, recorder=rec,
                hooks=RecoveryHooks(restart=restart,
                                    cold_restart=cold_restart,
                                    fallback_prec=self._fallback_prec,
                                    escalation=self._escalation),
                resilience=self._make_resilience())
            self._ring = eng.last_trace
        self._kinematics(x_fin, udi, delta)
        return flag, relres, total

    # -- resilience (the ladder's rungs are LadderPieces', on A: the shift
    # rides ops.diag, so the fallback is scalar Jacobi of A) -------------
    def _make_resilience(self) -> Optional[ResilienceContext]:
        """A step's chunk-level context (fault hooks, dispatch guard), or
        None when idle.  Timestep snapshots live one level up, in the
        guard of :meth:`run`."""
        sc = self.config.solver
        if sc.max_recoveries <= 0 and self.fault_plan is None:
            return None
        return ResilienceContext(
            step=len(self.flags) + 1,
            guard=DispatchGuard(retries=sc.dispatch_retries,
                                deadline_s=retry_deadline_s(),
                                recorder=self._rec),
            faults=self.fault_plan, recorder=self._rec,
            ladder_armed=sc.max_recoveries > 0)

    def _make_guard(self, resume: bool) -> Optional[TimeHistoryGuard]:
        """The timestep-granular harness of :meth:`run`: snapshots every
        ``config.snapshot_every`` steps, step faults, NaN/Inf rollback
        within ``config.solver.max_recoveries``."""
        every = int(self.config.snapshot_every)
        plan = self.fault_plan
        if every <= 0 and plan is None and not resume:
            return None
        store = (SnapshotStore.for_time_solver(self)
                 if every > 0 or resume else None)
        fetch, put = kinematic_state_io(self.device, self.dtype,
                                        ("u", "v", "w"))
        return TimeHistoryGuard(
            store=store, snapshot_every=every, fetch_state=fetch,
            put_state=put, recorder=self._rec, faults=plan,
            max_recoveries=int(self.config.solver.max_recoveries))

    def _history_state(self, t: int, deltas) -> dict:
        """The resumable state after completed step ``t``: the kinematic
        vectors, the step histories and the schedule."""
        return {"u": self.u, "v": self.v, "w": self.w, "t": np.int64(t),
                "flags": np.asarray(self.flags, np.int64),
                "relres": np.asarray(self.relres, np.float64),
                "iters": np.asarray(self.iters, np.int64),
                "deltas": np.asarray(deltas, np.float64)}

    # -- public -------------------------------------------------------------
    def step(self, delta_next: float) -> StepResult:
        """One step to t_{n+1} at load factor ``delta_next``: the chunked
        path when the dispatch cap is set, else one ``pcg`` /
        ``pcg_mixed`` call on A."""
        t0 = time.perf_counter()
        delta = float(delta_next)
        self._ring = None
        if self._dispatch_cap > 0:
            flag, relres, iters = self._step_chunked(delta)
        else:
            with self._rec.dispatch("step"):
                flag, relres, iters = self._step_oneshot(delta)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0
        res = StepResult(int(flag), float(relres), int(iters), wall)
        self.flags.append(res.flag)
        self.relres.append(res.relres)
        self.iters.append(res.iters)
        step_i = len(self.flags)
        self._rec.event("step", step=step_i, flag=res.flag,
                        relres=res.relres, iters=res.iters,
                        wall_s=round(wall, 6))
        if self.trace_len:
            self.last_trace = (unpack_trace(self._ring)
                               if self._ring is not None else empty_trace())
            self._ring = None
            self._rec.event("resid_trace",
                            **self.last_trace.to_event_fields(step_i))
        return res

    def run(self, load_factor: Sequence[float],
            init_accel_delta: Optional[float] = None,
            resume: bool = False) -> List[StepResult]:
        """One step per load factor (``load_factor[t]`` scales F, Ud and Vd
        at t_{t+1}).  ``init_accel_delta`` sets w consistently from the
        current state first, w = M^-1 (F delta - K u - C v).

        With ``config.snapshot_every > 0`` the state (u, v, w and the
        histories) is checkpointed every N completed steps
        (``step_*.npz``, retention ``PCG_TPU_SNAP_KEEP``); ``resume=True``
        restores the newest one and continues with bit-identical
        histories.  A non-finite state after a step rolls back to the last
        snapshot (within ``config.solver.max_recoveries``).  Returns the
        results of the steps this call ran."""
        deltas = [float(d) for d in load_factor]
        guard = self._make_guard(resume)
        t = 0
        if resume and guard is not None:
            got = guard.load_resume()
            if got is not None:
                t0, st = got
                if not np.array_equal(np.asarray(st["deltas"])[:t0],
                                      np.asarray(deltas)[:t0]):
                    raise ValueError(
                        "resume schedule mismatch: the snapshot was "
                        "written under a different load_factor prefix")
                self.u, self.v, self.w = st["u"], st["v"], st["w"]
                self.flags = [int(x) for x in np.asarray(st["flags"])]
                self.relres = [float(x) for x in np.asarray(st["relres"])]
                self.iters = [int(x) for x in np.asarray(st["iters"])]
                t = int(t0)
        if init_accel_delta is not None and t == 0:
            self.w = self._init_accel(float(init_accel_delta))
        t_start = t
        results: List[StepResult] = []
        while t < len(deltas):
            res = self.step(deltas[t])
            t += 1
            results.append(res)
            if not (math.isfinite(res.relres)
                    and bool(torch.isfinite(self.u).all())):
                if guard is None:
                    raise FloatingPointError(
                        f"non-finite state after Newmark step {t} and no "
                        "snapshot to roll back to (set snapshot_every)")
                t0, st = guard.rollback(t)
                self.u, self.v, self.w = st["u"], st["v"], st["w"]
                self.flags = self.flags[:t0]
                self.relres = self.relres[:t0]
                self.iters = self.iters[:t0]
                del results[max(t0 - t_start, 0):]
                t = t0
                continue
            if guard is not None:
                st = guard.boundary(t, lambda: self._history_state(t, deltas))
                if st is not None:
                    self.u, self.v, self.w = st["u"], st["v"], st["w"]
        self._rec.emit_run_summary()
        return results

    def displacement_global(self) -> np.ndarray:
        return owned_global(self.pm, self.u)

    def state_global(self):
        """(u, v, w) as global host vectors."""
        return tuple(owned_global(self.pm, a)
                     for a in (self.u, self.v, self.w))
