"""MATLAB-``pcg``-compatible preconditioned conjugate gradients.

Port of ``pcg_mpi_solver_tpu/solver/pcg.py`` (``pcg`` with
``variant="classic"``, ``pcg_mixed``, ``refine_tol``, ``PCGResult``).  The
JAX package runs the loop as one ``lax.while_loop`` whose decisions are
traced ``cond``/``where``; here the host drives the loop and branches on
scalars.  Each trip's vector work is queued on the device first and its
reductions come back in ONE host read at the end of the trip; every
decision is then taken on the host in numpy scalars of the reduction
(dot) dtype, so comparisons, square roots and divisions round exactly as
the device program's would.

Flags: 0 converged; 1 max-iterations; 2 inf preconditioner; 3 stagnation /
tolerance too small; 4 rho/pq breakdown.

One trip is one CG iteration (mode 0), or the deferred true-residual
check of the iteration committed on the trip before (mode 1), which does
not advance the iteration counter — iteration counts match the MATLAB
reference exactly, 1-based.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from pcg_mpi_solver_tpu_torch.ops.matvec import Ops


class PCGResult(NamedTuple):
    x: torch.Tensor       # (P, n_loc) solution on effective dofs (0 elsewhere)
    flag: int
    relres: np.float32
    iters: int            # 1-based, MATLAB-compatible


def _np_type(dtype: torch.dtype):
    """The numpy scalar type of a torch float dtype (host arithmetic in the
    device program's precision)."""
    return {torch.float32: np.float32, torch.float64: np.float64}[dtype]


def _read(*ts: torch.Tensor) -> np.ndarray:
    """ONE device->host read of several 0-d tensors, as float64 (exact for
    float32 and float64 values)."""
    return torch.stack([t.to(torch.float64) for t in ts]).cpu().numpy()


def refine_tol(tolb, normr, inner_tol) -> np.float32:
    """Adaptive inner tolerance for one mixed-precision refinement cycle:
    the final cycle only needs to contract the residual by tolb/normr — a
    fixed inner_tol would overshoot the outer tolerance.  Computed in the
    precision of ``tolb``/``normr``, returned as float32."""
    f = type(tolb)
    val = f(0.5) * tolb / max(normr, tolb * f(1e-30))
    return np.float32(min(max(val, f(inner_tol)), f(0.25)))


@dataclasses.dataclass
class _Carry:
    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    rho: torch.Tensor         # 0-d, dot dtype, on the device
    i: int
    flag: int
    stag: int
    moresteps: int
    iter_out: int
    normr_act: object         # numpy scalar, dot dtype
    normrmin: object
    xmin: torch.Tensor
    imin: int
    mode: int                 # 1 = the next trip is the deferred check


def pcg(
    ops: Ops,
    data: dict,
    fext: torch.Tensor,       # (P, n_loc) rhs, already restricted to eff dofs
    x0: torch.Tensor,         # (P, n_loc) initial guess (eff-restricted)
    inv_diag,                 # preconditioner operand (ops/precond.make_prec)
    tol,
    max_iter: int,
    glob_n_dof_eff: int,
    max_stag_steps: int = 3,
    max_iter_nominal: Optional[int] = None,
    return_carry: bool = False,
    x0_zero: bool = False,
    variant: str = "classic",
):
    """Returns PCGResult, or (PCGResult, carry) with ``return_carry``.

    ``return_carry`` skips the min-residual finalize and returns the raw
    continuation state (the last iterate, the tracked min-residual iterate
    and norms, and ``exec``, the executed trip count that the refinement
    shell budgets with).  ``x0_zero`` declares ``x0`` all zeros, so
    r0 = fext and ||r0|| = ||fext|| without a matvec.
    ``max_iter_nominal`` sets the MoreSteps budget when ``max_iter`` is a
    remaining-iterations cap."""
    if variant != "classic":
        raise NotImplementedError(
            f"pcg variant {variant!r} is not ported yet (ROADMAP queue 1 "
            f"item 6: PCG variants)")
    dd = ops.dot_dtype
    dt = fext.dtype
    f = _np_type(dd)          # host scalars in the dot dtype
    fs = _np_type(dt)         # host scalars in the storage dtype
    eff = data["eff"]
    w = data["weight"] * eff
    eps = f(np.finfo(fs).eps)

    # MATLAB: maxmsteps = min([floor(n/50), 5, n-maxit])
    nominal = max_iter_nominal if max_iter_nominal is not None else max_iter
    maxmsteps = min(glob_n_dof_eff // 50, 5, glob_n_dof_eff - nominal)

    n2b = np.sqrt(f(_read(ops.wdot(w, fext, fext))[0]))
    tolb = f(tol) * n2b

    def amul(v):
        """Assembled K.v restricted to effective dofs."""
        return eff * ops.matvec(data, v)

    if x0_zero:
        r0, normr0 = fext, n2b
    else:
        r0 = fext - amul(x0)
        normr0 = np.sqrt(f(_read(ops.wdot(w, r0, r0))[0]))

    zero_rhs = bool(n2b == 0)
    initial_ok = bool(normr0 <= tolb)
    c = _Carry(x=x0, r=r0, p=torch.zeros_like(x0),
               rho=torch.ones((), dtype=dd, device=fext.device), i=0,
               flag=0 if (zero_rhs or initial_ok) else 1,
               stag=0, moresteps=0, iter_out=0, normr_act=normr0,
               normrmin=normr0, xmin=x0, imin=0, mode=0)

    def resolve(x, r, p, rho, stag, normr_act, candidate):
        """Iteration epilogue: stag reset / MoreSteps / min-residual
        bookkeeping and the flag decision; ``candidate`` marks a
        true-residual check (then ``normr_act`` is the recomputed actual
        residual norm, else the recurrence norm)."""
        i = c.i
        converged = candidate and bool(normr_act <= tolb)
        failed_check = candidate and not converged
        if failed_check and stag >= max_stag_steps and c.moresteps == 0:
            stag = 0
        if failed_check:
            c.moresteps += 1
        toosmall = failed_check and c.moresteps >= maxmsteps
        if normr_act < c.normrmin:
            c.normrmin, c.xmin, c.imin = normr_act, x, i
        stagnated = stag >= max_stag_steps and not converged and not toosmall
        c.flag = 0 if converged else 3 if (toosmall or stagnated) else 1
        c.x, c.r, c.p, c.rho, c.stag = x, r, p, rho, stag
        c.iter_out = i
        c.i = i if c.flag != 1 else i + 1
        c.normr_act = normr_act
        c.mode = 0

    while c.flag == 1 and c.i < max_iter:
        if c.mode == 1:
            # the deferred check: recompute the ACTUAL residual of the
            # committed iterate before declaring convergence
            r_true = fext - amul(c.x)
            normr_act = np.sqrt(f(_read(ops.wdot(w, r_true, r_true))[0]))
            resolve(c.x, r_true, c.p, c.rho, c.stag, normr_act, True)
            continue

        i = c.i
        z = ops.apply_prec(inv_diag, c.r, data)
        inf_loc = torch.isinf(z).any()
        red = ops.wdots(w, [(z, c.r)], extra=[inf_loc])
        rho = red[0]
        beta = (rho / c.rho).to(dt)
        p = z if i == 0 else z + beta * c.p
        q = amul(p)
        pq = ops.wdot(w, p, q)
        alpha = (rho / pq).to(dt)
        r = c.r - alpha * q
        sq = ops.wdots(w, [(p, p), (c.x, c.x), (r, r)])
        v = _read(rho, red[1], beta, pq, alpha, sq[0], sq[1], sq[2])
        rho_h, beta_h, pq_h, alpha_h = f(v[0]), fs(v[2]), f(v[3]), fs(v[4])
        flag2 = bool(v[1] > 0)
        breakdown = (rho_h == 0 or np.isinf(rho_h)
                     or (i > 0 and (beta_h == 0 or np.isinf(beta_h)))
                     or pq_h <= 0 or np.isinf(pq_h) or np.isinf(alpha_h))
        if flag2 or breakdown:
            c.flag = 2 if flag2 else 4
            c.iter_out = i
            c.rho = rho
            break

        normp, normx, normr = (np.sqrt(f(v[5])), np.sqrt(f(v[6])),
                               np.sqrt(f(v[7])))
        stag = c.stag + 1 if normp * f(abs(alpha_h)) < eps * normx else 0
        x = c.x + alpha * p
        candidate = (normr <= tolb or stag >= max_stag_steps
                     or c.moresteps > 0)
        if candidate:
            # COMMIT the iterate but defer the epilogue to the next trip's
            # true-residual check; i, flag and the bookkeeping wait
            c.x, c.r, c.p, c.rho, c.stag = x, r, p, rho, stag
            c.iter_out = i
            c.mode = 1
        else:
            resolve(x, r, p, rho, stag, normr, False)

    # ---- finalize: on a non-converged exit return the minimal-residual
    # iterate when it has the smaller true residual (MATLAB pcg)
    x, normr_out, iters = c.x, c.normr_act, c.iter_out
    if not return_carry and c.flag != 0:
        r_min = fext - amul(c.xmin)
        normr_min = np.sqrt(f(_read(ops.wdot(w, r_min, r_min))[0]))
        if normr_min < c.normr_act:
            x, normr_out, iters = c.xmin, normr_min, c.imin

    if zero_rhs:
        # all-zero rhs => all-zero solution
        x = torch.zeros_like(x)
        relres = np.float32(0.0)
    else:
        relres = np.float32(normr_out / n2b)
    # +1 makes the count 1-based; the two pre-loop early exits report 0
    early = zero_rhs or initial_ok
    result = PCGResult(x=x, flag=0 if zero_rhs else c.flag, relres=relres,
                       iters=0 if early else iters + 1)
    if return_carry:
        carry = dict(x=c.x, r=c.r, p=c.p, rho=c.rho, stag=c.stag,
                     moresteps=c.moresteps, normrmin=c.normrmin,
                     xmin=c.xmin, imin=c.imin, normr_act=c.normr_act,
                     exec=0 if early else c.iter_out + 1)
        return result, carry
    return result


def pcg_mixed(
    ops32: Ops,
    data32: dict,
    ops64: Ops,
    data64: dict,
    fext: torch.Tensor,       # (P, n_loc) f64 rhs on eff dofs
    x0: torch.Tensor,         # (P, n_loc) f64 initial guess
    inv_diag32,               # f32 preconditioner operand
    tol: float,
    max_iter: int,
    glob_n_dof_eff: int,
    max_stag_steps: int = 3,
    inner_tol: float = 1e-5,
    max_outer: int = 12,
    variant: str = "classic",
) -> PCGResult:
    """Mixed-precision PCG by iterative refinement: f32 Krylov cycles on
    the NORMALIZED residual r/||r||, with the true residual recomputed and
    the solution accumulated in f64 at the top of every cycle.

    Exits: flag 0 when the f64 residual meets tol; 3 when a refinement
    cycle failed to halve it (stall); 2 after an inner inf-preconditioner
    exit; 1 when ``max_outer`` cycles or ``max_iter`` inner iterations are
    spent.  ``iters`` is the total of executed inner iterations."""
    eff64 = data64["eff"]
    w64 = data64["weight"] * eff64
    f = _np_type(ops64.dot_dtype)

    def amul64(v):
        return eff64 * ops64.matvec(data64, v)

    n2b = np.sqrt(f(_read(ops64.wdot(w64, fext, fext))[0]))
    tolb = f(tol) * n2b

    x = x0
    normr_prev = f(np.inf)
    outer, total = 0, 0
    flag = 0 if n2b == 0 else -1
    fatal2 = False
    normr = normr_prev
    while flag == -1:
        # the f64 residual of the CURRENT x, refreshed at the top of the body
        r = fext - amul64(x)
        normr = np.sqrt(f(_read(ops64.wdot(w64, r, r))[0]))
        converged = bool(normr <= tolb)
        # refinement must contract the residual (first trip: never trips)
        stalled = bool(normr > f(0.5) * normr_prev)
        exhausted = outer >= max_outer or total >= max_iter
        run_inner = not (converged or stalled or fatal2 or exhausted)
        inner_flag = 1
        if run_inner:
            rhat32 = (r / float(normr)).to(torch.float32)
            inner, icarry = pcg(
                ops32, data32,
                fext=rhat32,
                x0=torch.zeros_like(rhat32),
                inv_diag=inv_diag32,
                tol=refine_tol(tolb, normr, inner_tol),
                max_iter=max(max_iter - total, 1),
                glob_n_dof_eff=glob_n_dof_eff,
                max_stag_steps=max_stag_steps,
                max_iter_nominal=max_iter,
                return_carry=True,
                x0_zero=True,
                variant=variant,
            )
            # return_carry skips the min-residual finalize: on a
            # non-converged exit take the tracked min-residual iterate
            # when its recurrence norm is the smaller one
            use_min = inner.flag != 0 and icarry["normrmin"] < icarry["normr_act"]
            xbest = icarry["xmin"] if use_min else inner.x
            x = x + xbest.to(fext.dtype) * float(normr)
            total += max(icarry["exec"], 1)
            outer += 1
            inner_flag = inner.flag
        flag = (0 if converged else 3 if stalled else 2 if fatal2
                else 1 if exhausted else -1)
        normr_prev = normr
        fatal2 = inner_flag == 2

    zero_rhs = bool(n2b == 0)
    relres = np.float32(0.0) if zero_rhs else np.float32(normr / n2b)
    x = torch.zeros_like(x) if zero_rhs else x
    return PCGResult(x=x, flag=flag, relres=relres, iters=total)
