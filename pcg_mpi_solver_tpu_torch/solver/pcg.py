"""MATLAB-``pcg``-compatible preconditioned conjugate gradients.

Port of ``pcg_mpi_solver_tpu/solver/pcg.py`` (``pcg`` with its three loop
formulations, ``pcg_mixed``, ``refine_tol``, ``PCGResult``).  The JAX
package runs the loop as one ``lax.while_loop`` whose decisions are
traced ``cond``/``where``; here the host drives the loop and branches on
scalars.  Each trip's vector work is queued on the device first and its
reductions come back in ONE host read; every decision is then taken on
the host in numpy scalars of the reduction (dot) dtype, so comparisons,
square roots and divisions round exactly as the device program's would.

Flags: 0 converged; 1 max-iterations; 2 inf preconditioner; 3 stagnation /
tolerance too small; 4 rho/pq breakdown; 6 sustained residual drift of a
recurrence variant (``DRIFT_FLAG``).

Variants (``VALID_PCG_VARIANTS``):

- ``classic``: the MATLAB loop, three reductions a trip.  One trip is one
  CG iteration (mode 0), or the deferred true-residual check of the
  iteration committed on the trip before (mode 1), which does not advance
  the iteration counter — iteration counts match the MATLAB reference
  exactly, 1-based.
- ``fused``: the Chronopoulos–Gear recurrence.  z = M^-1 r and w = A z,
  then every dot of the trip in ONE reduction; p and q = A p advance by
  recurrence, <p, Ap> = mu - beta*rho/alpha_prev.  The reduction reads
  the residual of the iterate committed on the trip before, so the
  epilogue resolves that (lagged) iterate while the trip's update is
  committed.  The trip queues its update speculatively with alpha and
  beta computed on the device, and drops it when the host finds a
  candidate.
- ``pipelined``: Ghysels–Vanroose depth-1 CG.  The one reduction reads
  only the carry (u = M^-1 r and w = A u ride it by recurrence), so it is
  queued first and copied to pinned host memory behind an event before
  the trip's m = M^-1 w and n = A m are queued: the host waits for the
  reduction, and takes its decision, while the stencil kernel runs.  A
  priming trip (cold start, and after every check) computes u and w.
  Every ``PIPELINED_REPLACE_EVERY`` committed iterations a check is
  forced: the true residual replaces the recurrence one.

Both recurrence variants (``LAGGED_VARIANTS``) gate a candidate check on a
committed update since the last one (``fresh``), count checks whose true
residual is more than ``FUSED_DRIFT_FACTOR`` times the recurrence norm
(``drift``), exit with flag 6 at ``drift_limit_for(variant)`` of them, and
on a non-converged exit return the min-residual iterate unconditionally.
Iteration counts differ from classic by O(1).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from pcg_mpi_solver_tpu_torch.config import PCG_VARIANTS
from pcg_mpi_solver_tpu_torch.ops.matvec import Ops

# Flags that mean the Krylov recurrence collapsed, not that the system is
# unsolvable: a restart from the min-residual iterate routinely completes
# the solve (the JAX package's recovery ladder; not ported yet).
BREAKDOWN_FLAGS = (2, 4, 6)

# Residual-drift guard of the recurrence variants: a non-converged
# deferred check whose true residual exceeds FUSED_DRIFT_FACTOR x the
# recurrence norm that prompted it counts one drift; at the variant's
# limit the solve exits with DRIFT_FLAG.
DRIFT_FLAG = 6
FUSED_DRIFT_FACTOR = 2.0
FUSED_DRIFT_LIMIT = 3
# pipelined keeps four more vectors current by recurrence, drifts faster,
# and gets the lower limit
PIPELINED_DRIFT_LIMIT = 2
# Forced true-residual replacement of the pipelined variant: a check trip
# after this many committed iterations without one.  It does not advance
# the iteration counter, count a MoreSteps or touch stagnation; it costs
# ~3 matvec-bearing trips (the dropped trip, the check, the re-prime).
PIPELINED_REPLACE_EVERY = 25

VALID_PCG_VARIANTS = PCG_VARIANTS
# variants whose convergence bookkeeping lags the committed iterate by
# one trip
LAGGED_VARIANTS = ("fused", "pipelined")


def drift_limit_for(variant: str) -> int:
    """Flag-6 drift budget of a recurrence variant's deferred checks."""
    return (PIPELINED_DRIFT_LIMIT if variant == "pipelined"
            else FUSED_DRIFT_LIMIT)


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
    """ONE device->host read of several 0-d or 1-d tensors, as float64
    (exact for float32 and float64 values)."""
    return torch.cat([t.reshape(-1).to(torch.float64) for t in ts]
                     ).cpu().numpy()


class _EarlyRead:
    """A device->host read started before more work is queued: on the card
    a non-blocking copy into pinned memory behind an event, which the host
    waits on (not on the stream), so the work queued after ``start`` runs
    while the host holds the values; on the CPU a plain copy."""

    def __init__(self, device: torch.device, n: int):
        self.cuda = device.type == "cuda"
        self.host = torch.empty(n, dtype=torch.float64, pin_memory=self.cuda)
        self.done = torch.cuda.Event() if self.cuda else None

    def start(self, t: torch.Tensor) -> None:
        self.host.copy_(t.to(torch.float64), non_blocking=self.cuda)
        if self.cuda:
            self.done.record(torch.cuda.current_stream(t.device))

    def wait(self) -> np.ndarray:
        if self.cuda:
            self.done.synchronize()
        return self.host.numpy().copy()


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
    rho: object               # 0-d dot-dtype tensor on the device (classic,
                              # fused); numpy scalar (pipelined)
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
    # -- the recurrence variants (LAGGED_VARIANTS) --
    q: Optional[torch.Tensor] = None   # fused: A.p; pipelined: M^-1.s
    alpha: Optional[torch.Tensor] = None  # fused: the last step, device
    alpha_h: object = None    # the last step on the host (dot dtype)
    fresh: int = 1            # an update was committed since the last check
    drift: int = 0            # drifted deferred checks
    chk_normr: object = None  # recurrence norm that prompted the check
    # -- pipelined only --
    u: Optional[torch.Tensor] = None   # M^-1.r
    w: Optional[torch.Tensor] = None   # A.u
    s: Optional[torch.Tensor] = None   # A.p
    z: Optional[torch.Tensor] = None   # A.q
    init: int = 1             # the next iterate trip is a priming trip
    sc: int = 0               # committed iterations since the last check
    chk_forced: int = 0       # the pending check was forced by sc alone


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
    and norms, the recurrence state of a lagged variant, and ``exec``, the
    executed trip count that the refinement shell budgets with).
    ``x0_zero`` declares ``x0`` all zeros, so r0 = fext and ||r0|| =
    ||fext|| without a matvec.  ``max_iter_nominal`` sets the MoreSteps
    budget when ``max_iter`` is a remaining-iterations cap.  ``variant``
    is one of ``VALID_PCG_VARIANTS`` (module docstring); every call is a
    cold start."""
    if variant not in VALID_PCG_VARIANTS:
        raise ValueError(f"pcg variant must be one of "
                         f"{VALID_PCG_VARIANTS}, got {variant!r}")
    lagged = variant in LAGGED_VARIANTS
    pipelined = variant == "pipelined"
    drift_limit = drift_limit_for(variant)
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
    if lagged:
        # cold values make the first trip the textbook first CG step:
        # p = q = 0 collapse the recurrences, and alpha_prev = inf zeroes
        # the denominator's correction (beta*rho/inf == 0)
        c.q = torch.zeros_like(x0)
        c.alpha = torch.full((), np.inf, dtype=dd, device=fext.device)
        c.alpha_h = f(np.inf)
        c.chk_normr = f(0)
    if pipelined:
        c.u, c.w, c.s, c.z = (torch.zeros_like(x0) for _ in range(4))
        c.rho = f(1)
        early = _EarlyRead(fext.device, 6)

    def resolve(x, r, p, rho, stag, normr_act, candidate, advance=True,
                extra=None):
        """Iteration epilogue: stag reset / MoreSteps / min-residual
        bookkeeping and the flag decision; ``candidate`` marks a
        true-residual check (then ``normr_act`` is the recomputed actual
        residual norm, else the recurrence norm).  ``extra`` sets carry
        fields AFTER the bookkeeping: a lagged trip tracks the min
        residual against the lagged iterate ``x`` while it commits the
        fresh update.  ``advance=False`` keeps ``i`` (a lagged check
        committed no update)."""
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
        c.i = i if (c.flag != 1 or not advance) else i + 1
        c.normr_act = normr_act
        c.mode = 0
        for k, v in (extra or {}).items():
            setattr(c, k, v)

    def true_norm(x):
        """(fext - A.x, its norm): the deferred check's actual residual."""
        r_true = fext - amul(x)
        return r_true, np.sqrt(f(_read(ops.wdot(w, r_true, r_true))[0]))

    def classic_check():
        # recompute the ACTUAL residual of the committed iterate before
        # declaring convergence
        r_true, normr_act = true_norm(c.x)
        resolve(c.x, r_true, c.p, c.rho, c.stag, normr_act, True)

    def classic_trip():
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
            return

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

    def lagged_stag(normr, normp, normx):
        """(already, stag, natural candidacy) of the lagged iterate: the
        update committed on the trip before moved x by alpha_prev * p.
        ``already``: a failed check resolved this iterate, so it is neither
        stag-checked nor a candidate again.  On a cold start p = 0 and
        alpha_prev = inf make the product NaN, which compares False."""
        already = c.fresh == 0
        with np.errstate(invalid="ignore"):
            small = normp * abs(c.alpha_h) < eps * normx
        stag = c.stag if already else (c.stag + 1 if small else 0)
        natural = bool(normr <= tolb or stag >= max_stag_steps
                       or c.moresteps > 0)
        return already, stag, natural

    def lagged_stop(i, scalars, rho, stag, normr, flag2, candidate,
                    forced=False) -> bool:
        """A lagged trip's exits before its commit; True when the trip
        ends here.  A breakdown of the recurrence's scalars (rho, beta,
        pq, alpha; classic's taxonomy) ends the solve unless the iterate
        is a candidate, whose true-residual check decides first; a
        candidate is deferred to the next trip's check with nothing
        committed (``forced``: by the replacement cadence alone)."""
        rho_h, beta, pq, alpha = scalars
        breakdown = (rho_h == 0 or np.isinf(rho_h) or beta == 0
                     or np.isinf(beta) or pq <= 0 or np.isinf(pq)
                     or np.isinf(alpha))
        if (flag2 or breakdown) and not candidate:
            c.flag, c.iter_out, c.rho = (2 if flag2 else 4), i, rho
            return True
        if candidate:
            c.stag, c.iter_out, c.mode, c.chk_normr = stag, i, 1, normr
            c.chk_forced = int(forced)
            return True
        return False

    def lagged_check():
        """The deferred true-residual check of a lagged variant: ``i``
        stays (no update was committed on the candidate trip), ``fresh``
        drops, and the drift guard counts a check whose true residual
        exceeds FUSED_DRIFT_FACTOR x the recurrence norm that prompted it.
        Pipelined also replaces the residual chain: the next trip
        re-primes u and w from the true residual; a check forced by the
        cadence alone is no candidate (no MoreSteps)."""
        r_true, normr_act = true_norm(c.x)
        disagree = bool(normr_act > tolb
                        and normr_act > f(FUSED_DRIFT_FACTOR) * c.chk_normr)
        drift = c.drift + int(disagree)
        extra = dict(fresh=0, drift=drift)
        if pipelined:
            extra.update(init=1, sc=0, chk_forced=0)
        resolve(c.x, r_true, c.p, c.rho, c.stag, normr_act,
                c.chk_forced == 0, advance=False, extra=extra)
        if c.flag == 1 and drift >= drift_limit:
            c.flag = DRIFT_FLAG

    def fused_trip():
        i = c.i
        z = ops.apply_prec(inv_diag, c.r, data)
        wz = amul(z)
        inf_loc = torch.isinf(z).any()
        red = ops.wdots(w, [(c.r, z), (z, wz), (c.r, c.r), (c.p, c.p),
                            (c.x, c.x)], extra=[inf_loc])
        rho, mu = red[0], red[1]
        # Chronopoulos–Gear scalars on the device, in the dot dtype
        beta = rho / c.rho
        pq = mu - beta * rho / c.alpha
        alpha = rho / pq
        # the update, queued speculatively (dropped on a candidate trip)
        beta_dt, alpha_dt = beta.to(dt), alpha.to(dt)
        p = z + beta_dt * c.p
        q = wz + beta_dt * c.q
        x = c.x + alpha_dt * p
        r = c.r - alpha_dt * q
        v = _read(red, beta, pq, alpha)
        normr, normp, normx = (np.sqrt(f(v[2])), np.sqrt(f(v[3])),
                               np.sqrt(f(v[4])))
        flag2 = bool(v[5] > 0)
        already, stag, natural = lagged_stag(normr, normp, normx)
        alpha_h = f(v[8])
        if lagged_stop(i, (f(v[0]), f(v[6]), f(v[7]), alpha_h), rho, stag,
                       normr, flag2, natural and not already):
            return
        resolve(c.x, c.r, c.p, rho, stag, normr, False,
                extra=dict(x=x, r=r, p=p, q=q, alpha=alpha, alpha_h=alpha_h,
                           fresh=1))

    def pipelined_trip():
        i = c.i
        if c.init:
            # priming: u0 = M^-1.r0, w0 = A.u0; nothing else is committed
            c.u = ops.apply_prec(inv_diag, c.r, data)
            c.w = amul(c.u)
            c.init = 0
            return
        # the ONE reduction, on carry leaves only, queued first and read
        # back while the trip's preconditioner and stencil run
        inf_loc = torch.isinf(c.u).any()
        red = ops.wdots(w, [(c.r, c.u), (c.w, c.u), (c.r, c.r),
                            (c.p, c.p), (c.x, c.x)], extra=[inf_loc])
        early.start(red)
        m = ops.apply_prec(inv_diag, c.w, data)
        km = amul(m)
        v = early.wait()
        gamma, delta = f(v[0]), f(v[1])
        normr, normp, normx = (np.sqrt(f(v[2])), np.sqrt(f(v[3])),
                               np.sqrt(f(v[4])))
        flag2 = bool(v[5] > 0)
        already, stag, natural = lagged_stag(normr, normp, normx)
        forced = c.sc >= PIPELINED_REPLACE_EVERY
        candidate = (natural or forced) and not already
        # GV scalars (delta - beta*gamma/alpha_prev is <p, Ap>)
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            beta = gamma / c.rho
            pq = delta - beta * gamma / c.alpha_h
            alpha = gamma / pq
        if lagged_stop(i, (gamma, beta, pq, alpha), gamma, stag, normr,
                       flag2, candidate, forced and not natural):
            return
        b, a = float(fs(beta)), float(fs(alpha))
        p = c.u + b * c.p           # p = 0 cold => p = u
        s = c.w + b * c.s           # A.p by recurrence
        q = m + b * c.q             # M^-1.s by recurrence
        z = km + b * c.z            # A.q by recurrence
        resolve(c.x, c.r, c.p, gamma, stag, normr, False,
                extra=dict(x=c.x + a * p, r=c.r - a * s, p=p, s=s, q=q, z=z,
                           u=c.u - a * q, w=c.w - a * z, alpha_h=alpha,
                           fresh=1, sc=c.sc + 1))

    trip, check = {"classic": (classic_trip, classic_check),
                   "fused": (fused_trip, lagged_check),
                   "pipelined": (pipelined_trip, lagged_check)}[variant]
    while c.flag == 1 and c.i < max_iter:
        if c.mode == 1:
            check()
        else:
            trip()

    # ---- finalize: on a non-converged exit return the minimal-residual
    # iterate when it has the smaller true residual (MATLAB pcg); a lagged
    # variant's last iterate was never evaluated, so it returns the
    # min-residual iterate unconditionally
    x, normr_out, iters = c.x, c.normr_act, c.iter_out
    if not return_carry and c.flag != 0:
        _r_min, normr_min = true_norm(c.xmin)
        if lagged or normr_min < c.normr_act:
            x, normr_out, iters = c.xmin, normr_min, c.imin

    if zero_rhs:
        # all-zero rhs => all-zero solution
        x = torch.zeros_like(x)
        relres = np.float32(0.0)
    else:
        relres = np.float32(normr_out / n2b)
    # +1 makes the count 1-based; the two pre-loop early exits report 0
    early_exit = zero_rhs or initial_ok
    result = PCGResult(x=x, flag=0 if zero_rhs else c.flag, relres=relres,
                       iters=0 if early_exit else iters + 1)
    if return_carry:
        carry = dict(x=c.x, r=c.r, p=c.p, rho=c.rho, stag=c.stag,
                     moresteps=c.moresteps, normrmin=c.normrmin,
                     xmin=c.xmin, imin=c.imin, normr_act=c.normr_act,
                     exec=0 if early_exit else c.iter_out + 1)
        if lagged:
            carry.update(q=c.q, alpha=c.alpha_h, fresh=c.fresh,
                         drift=c.drift)
        if pipelined:
            carry.update(u=c.u, w=c.w, s=c.s, z=c.z, init=c.init, sc=c.sc)
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
