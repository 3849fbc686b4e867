"""Dispatch-chunked PCG execution.

Port of ``pcg_mpi_solver_tpu/solver/chunked.py:41-659``.  Above 4 M dofs
(``auto_dispatch_cap``), or whenever ``SolverConfig.iters_per_dispatch``
names a cap, ``Solver.step`` splits a solve into capped calls of the
resumable ``pcg`` (``carry_in``), each at most ``cap`` Krylov
iterations, with all state resident on the device between calls.  The
boundaries between calls are where the resilience subsystem acts: the
state is snapshotted there, faults fire there, a NaN carry is caught
there within one chunk, and a device-loss exception is re-dispatched
from the last snapshot.

Direct mode: N capped calls are iteration for iteration, and bit for
bit, one long solve.  Mixed mode is the JAX package's chunked
refinement loop, NOT ``pcg_mixed``: each refinement cycle runs its f32
inner solve to its own convergence through capped calls that resume the
f32 carry, a failed inner solve takes the min-residual selection
(``select_best``, one f32 matvec), the f64 refresh follows, and a cycle
that contracts the residual by less than 0.9 counts a stall; two in a
row end the solve with flag 3.  There is no cap on the cycle count.

The JAX package's pieces are jitted programs; here each is a host
function over tensors (mixed: ``inner_start``, ``inner_cycle``,
``final32``, ``refine``; direct: ``cycle``, ``final``), each timed as a
``dispatch`` span when a recorder is attached.  One capped ``pcg`` call
is one dispatch for the fault counters.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, List, Optional

import numpy as np
import torch

from pcg_mpi_solver_tpu_torch.obs.trace import trace_init
from pcg_mpi_solver_tpu_torch.solver.pcg import (
    LAGGED_VARIANTS, _read, cold_carry, mixed_windows, pcg, refine_tol,
    select_best)


def _state_kind(state) -> str:
    """The ``kind`` tag of a (possibly npz round-tripped) snapshot."""
    return str(np.asarray(state.get("kind", "")))


class ChunkedEngine:
    """Capped-dispatch budget loop over the resumable ``pcg``.

    ``ops`` is the f64 (direct: the solve dtype's) operator; in mixed
    mode ``ops32`` runs the f32 inner solves, ``data`` passed to
    :meth:`run` is ``{"f64": ..., "f32": ...}`` and the preconditioner
    operand is f32.  ``log``, when given, collects one tuple per piece
    run: ``("cycle" | "inner", executed iterations, flag)`` for each
    capped call and ``("refine", inner flag, cycle iterations)`` for each
    refinement cycle (the chip smoke test prints them).  ``kmul64``,
    when given, computes the refinement's float64 K.x as ``kmul64(data64,
    x)`` in place of ``ops.matvec`` (the hybrid backend's refresh
    operator, as the JAX package's ``_amul64_fn``).

    ``trace_len`` > 0 gives each :meth:`run` a convergence ring
    (``obs/trace.py``) of that length, of ``trace_dtype``, which every
    capped call records into (mixed: rescaled by its cycle's refresh
    norm): the ring rides the calls on the device, rides the snapshots,
    and is left on ``self.last_trace`` after the run, in the JAX
    package's slots, so a chunked solve's trace is its one-shot
    trace."""

    def __init__(self, *, ops, scfg, glob_n_dof_eff: int, cap: int,
                 mixed: bool, ops32=None, recorder=None,
                 log: Optional[List[tuple]] = None,
                 kmul64: Optional[Callable] = None, trace_len: int = 0,
                 trace_dtype: torch.dtype = torch.float32):
        self.ops, self.ops32 = ops, ops32
        self.kmul64 = kmul64 if kmul64 is not None else ops.matvec
        self.scfg = scfg
        self.glob_n_dof_eff = int(glob_n_dof_eff)
        self.cap = int(cap)
        self.mixed = mixed
        self.variant = scfg.pcg_variant
        self.always_min = self.variant in LAGGED_VARIANTS
        self._rec = recorder
        self.log = log if log is not None else []
        self.restart_x = None
        self.trace_len = int(trace_len)
        self.trace_dtype = trace_dtype
        self.last_trace = None

    def _disp(self, name: str):
        """A ``dispatch`` span when a recorder is attached."""
        if self._rec is None:
            return contextlib.nullcontext()
        return self._rec.dispatch(name)

    def _capped(self, ops, data, fext, prec, carry, tol, total,
                windows=None, scale=None):
        """One capped call of the resumable ``pcg``: at most ``cap``
        iterations and the budget's remainder; MoreSteps sized by the
        nominal ``max_iter``; ``windows`` the mixed shell's plateau and
        progress exits (an inner f32 cycle's only), whose clocks ride
        the carry across calls.  The run's ring records the call's
        iterations (``scale``: a mixed cycle's refresh norm)."""
        scfg = self.scfg
        res, carry = pcg(ops, data, fext, carry["x"], prec, tol=tol,
                         max_iter=min(self.cap, scfg.max_iter - total),
                         glob_n_dof_eff=self.glob_n_dof_eff,
                         max_stag_steps=scfg.max_stag_steps,
                         max_iter_nominal=scfg.max_iter, carry_in=carry,
                         return_carry=True, variant=self.variant,
                         trace_in=self.last_trace, trace_scale=scale,
                         **(windows or {}))
        return res, carry

    def run(self, data, fext, carry, normr0, n2b, prec,
            vlog: Optional[Callable[[str], None]] = None,
            resilience=None, total0: int = 0):
        """Budget loop from a prepared start state to termination.

        ``carry``: a cold carry at the start iterate (``cold_carry``);
        ``prec``: the preconditioner operand (f32 in mixed mode).  Returns
        ``(x_fin, flag, relres, total_iters)``; ``total0`` continues the
        iteration budget across ladder restarts and resumes.  The caller
        handles ``n2b == 0``.  ``resilience`` (``ResilienceContext``)
        threads the hooks: snapshots and faults at chunk boundaries, the
        guard's re-dispatch from a snapshot after a device-loss
        exception, a persisted mid-step snapshot in place of the cold
        start (``resume``), and a non-finite residual ending the loop
        within one chunk.  Afterwards ``self.restart_x`` holds the
        iterate a ladder restart starts from (direct: the min-residual
        iterate; mixed: the last iterate whose f64 refresh was finite)."""
        vlog = vlog or (lambda s: None)
        self.restart_x = None
        self.last_trace = (trace_init(self.trace_len, self.trace_dtype)
                           if self.trace_len > 0 else None)
        n2b_f = float(n2b)
        tolb = self.scfg.tol * n2b_f
        cur = float(normr0)
        resume = (resilience.load_resume_state()
                  if resilience is not None else None)
        if cur <= tolb and resume is None:
            # converged at entry (a ladder restart iterate already at tol)
            self.restart_x = carry.get("xmin")
            return carry["x"], 0, cur / n2b_f, int(total0)
        if self.mixed:
            return self._run_mixed(data, fext, carry, normr0, n2b_f, prec,
                                   vlog, resilience, int(total0), resume)
        return self._run_direct(data, fext, carry, n2b_f, prec,
                                resilience, int(total0), resume)

    # -- mixed: f32 inner cycles inside f64 refinement ------------------
    def _run_mixed(self, data, fext, carry, normr0, n2b_f, prec, vlog,
                   resilience, total, resume):
        scfg = self.scfg
        ops, ops32 = self.ops, self.ops32
        data64, data32 = data["f64"], data["f32"]
        eff = data64["eff"]
        w = data64["weight"] * eff
        f = np.float64
        tolb = scfg.tol * n2b_f
        faults = resilience.faults if resilience is not None else None
        x, r, normr = carry["x"], carry["r"], f(float(normr0))
        cur = float(normr)
        stall, chunk_i, flag = 0, 0, 1

        def restore(st):
            """Snapshot state -> (x, r, normr, stall, total): the one
            mixed restore of the resume and of the guard's re-dispatch
            (the ring too, when both trace)."""
            dev = resilience.restore_device({k: st[k] for k in ("x", "r")})
            self._restore_ring(st)
            return (dev["x"], dev["r"], f(np.asarray(st["normr"])),
                    int(np.asarray(st["stall"])),
                    int(np.asarray(st["total"])))

        if resume is not None and _state_kind(resume) == "mixed":
            x, r, normr, stall, total = restore(resume)
            cur = float(normr)
        # the restart iterate: copied once a cycle, and only when the
        # driver's ladder will read it
        keep_restart = resilience is not None and resilience.ladder_armed
        good_x = x.clone() if keep_restart else None
        while flag == 1 and total < scfg.max_iter:
            if resilience is not None:
                resilience.sync_boundary()
            prev = cur
            try:
                # one refinement cycle: the f32 inner solve to ITS
                # convergence through capped calls, then the refresh
                vlog(f"inner_start dispatch (normr={float(normr):.3e})")
                with self._disp("inner_start"):
                    tol_cycle = refine_tol(f(scfg.tol) * f(n2b_f), normr,
                                           scfg.inner_tol)
                    rhat32 = (r / float(normr)).to(torch.float32)
                    # ||rhat|| = 1 exactly: no matvec needed
                    c32 = cold_carry(torch.zeros_like(rhat32), rhat32, 1.0,
                                     ops32.dot_dtype, variant=self.variant)
                inner_flag, cycle_iters = 1, 0
                first_dispatch, poisoned = True, False
                while inner_flag == 1 and total < scfg.max_iter:
                    vlog(f"inner_cycle dispatch (total={total})")
                    if faults is not None:
                        faults.on_dispatch()
                    with self._disp("inner_cycle"):
                        # inner iterations run on r / normr: the ring
                        # records absolute residuals
                        res, c32 = self._capped(ops32, data32, rhat32, prec,
                                                c32, tol_cycle, total,
                                                mixed_windows(scfg),
                                                scale=normr)
                        exec_n = int(c32["exec"])
                        total += exec_n
                        inner_flag = int(res.flag)
                    xin = res.x
                    cycle_iters += exec_n
                    self.log.append(("inner", exec_n, inner_flag))
                    if faults is not None:
                        faults.on_dispatch_done()
                    vlog(f"inner_cycle done: +{exec_n} iters "
                         f"flag={inner_flag}")
                    if resilience is not None:
                        # corruption off already-read scalars: flag 0 in
                        # 0 iterations on a cycle's first dispatch is
                        # impossible for the unit-norm rhs unless an inf
                        # rhs faked tolb = inf; a NaN norm trips no flag
                        if (first_dispatch and inner_flag == 0
                                and exec_n == 0) or not math.isfinite(
                                    float(c32["normr_act"])):
                            vlog("inner state non-finite/corrupt; handing "
                                 "the step to the recovery ladder")
                            poisoned = True
                            break
                    first_dispatch = False
                if poisoned:
                    cur = float("nan")
                    break
                if inner_flag != 0:
                    # failed or exhausted inner solve: min-residual pick
                    with self._disp("final32"):
                        xin, _ = select_best(ops32, data32, rhat32, c32,
                                             always_min=self.always_min)
                vlog("refine dispatch (f64 true-residual matvec)")
                with self._disp("refine"):
                    x = x + xin.to(x.dtype) * float(normr)
                    r = fext - eff * self.kmul64(data64, x)
                    normr = np.sqrt(f(_read(ops.wdot(w, r, r))[0]))
                    cur = float(normr)
                self.log.append(("refine", inner_flag, cycle_iters))
            except Exception as e:                      # noqa: BLE001
                st = (resilience.handle_dispatch_failure(e, "mixed")
                      if resilience is not None else None)
                if st is None:
                    raise
                # re-dispatch from the snapshot: lose at most one
                # snapshot interval, not the step
                x, r, normr, stall, total = restore(st)
                cur = float(normr)
                if keep_restart:
                    good_x = x.clone()
                continue
            vlog(f"refine done: relres={cur / n2b_f:.3e} total={total}")
            if not math.isfinite(cur):
                # poisoned: never snapshot non-finite state; the ladder
                # restarts from restart_x
                break
            if keep_restart:
                good_x = x.clone()
            chunk_i += 1
            if cur <= tolb:
                flag = 0
            elif inner_flag == 2:
                flag = 2
            elif cur > 0.9 * prev:
                # no meaningful contraction over a refinement cycle
                stall += 1
                if stall >= 2:
                    flag = 3
            else:
                stall = 0
            if resilience is not None and flag == 1:
                resilience.after_chunk(lambda: dict(
                    kind="mixed", chunk=chunk_i, total=total, stall=stall,
                    normr=normr, x=x, r=r, **self._ring_state()))
                if faults is not None:
                    r = faults.at_boundary({"r": r})["r"]
        self.restart_x = good_x if good_x is not None else x
        return x, flag, cur / n2b_f, total

    # -- direct: one resumable Krylov solve -----------------------------
    def _run_direct(self, data, fext, carry, n2b_f, prec, resilience,
                    total, resume):
        scfg = self.scfg
        faults = resilience.faults if resilience is not None else None
        flag, chunk_i = 1, 0
        relres = float(carry["normr_act"]) / n2b_f
        x_fin = carry["x"]

        def restore(st):
            """Snapshot state -> (carry, total, relres): the one direct
            restore of the resume and of the guard's re-dispatch (the
            ring too, when both trace)."""
            self._restore_ring(st)
            c = resilience.restore_device({"carry": dict(st["carry"])})
            return (c["carry"], int(np.asarray(st["total"])),
                    float(np.asarray(st["carry"]["normr_act"])) / n2b_f)

        if resume is not None and _state_kind(resume) == "direct":
            carry, total, relres = restore(resume)
            x_fin = carry["x"]
        while flag == 1 and total < scfg.max_iter:
            if resilience is not None:
                resilience.sync_boundary()
            try:
                if faults is not None:
                    faults.on_dispatch()
                with self._disp("cycle"):
                    res, carry = self._capped(self.ops, data, fext, prec,
                                              carry, scfg.tol, total)
                    total += int(carry["exec"])
                    flag = int(res.flag)
                    relres = float(res.relres)
                x_fin = res.x
                self.log.append(("cycle", int(carry["exec"]), flag))
            except Exception as e:                      # noqa: BLE001
                st = (resilience.handle_dispatch_failure(e, "direct")
                      if resilience is not None else None)
                if st is None:
                    raise
                carry, total, relres = restore(st)
                flag = 1
                continue
            if faults is not None:
                faults.on_dispatch_done()
            chunk_i += 1
            if flag != 1 or not math.isfinite(relres):
                # terminal, or a NaN carry (no flag trips on NaN): never
                # snapshot past this point
                break
            if resilience is not None:
                resilience.after_chunk(lambda: dict(
                    kind="direct", chunk=chunk_i, total=total,
                    carry=carry, **self._ring_state()))
                if faults is not None:
                    carry = faults.at_boundary(carry)
        if flag != 0:
            # terminal failure: the min-residual fallback the resumable
            # calls defer, once a step
            with self._disp("final"):
                x_fin, best = select_best(self.ops, data, fext, carry,
                                          always_min=self.always_min)
            # a NaN carry stays visible to the ladder's nan_carry trigger
            # (the always-min pick reports a finite residual)
            if math.isfinite(relres):
                relres = float(best)
        # the min-residual restart iterate: only finite committed
        # iterates reach it, so it survives NaN poisoning and breakdowns
        self.restart_x = carry["xmin"]
        if self.always_min and self._rec is not None:
            d = int(carry["drift"])
            if d > 0:
                self._rec.event("resid_drift", drift=d)
                self._rec.gauge("resid.drift", d)
        return x_fin, flag, relres, total


    def _ring_state(self) -> dict:
        """The ring's part of a snapshot state (nothing when off)."""
        if self.last_trace is None:
            return {}
        return {"trace": self.last_trace.state()}

    def _restore_ring(self, st) -> None:
        """Restore the ring from a snapshot state that carries one."""
        if self.last_trace is not None and "trace" in st:
            self.last_trace.load_state(st["trace"])


def auto_dispatch_cap(scfg, glob_n_dof: int, n_loc_dev: int,
                      force_engage: bool = False) -> int:
    """Resolve ``SolverConfig.iters_per_dispatch``: -1 (auto) engages at
    4,000,000 dofs and above, with a cap sized so one dispatch stays
    well under a minute (``max(200, 45 / (4e-9 * n_loc_dev))``); 0 is the
    one-shot path; a positive value is the cap at any size."""
    cap = scfg.iters_per_dispatch
    if cap < 0:
        if glob_n_dof < 4_000_000 and not force_engage:
            cap = 0
        else:
            cap = max(200, int(45.0 / (4e-9 * max(n_loc_dev, 1))))
    return int(cap)
