"""MATLAB-``pcg``-compatible preconditioned conjugate gradients.

Port of ``pcg_mpi_solver_tpu/solver/pcg.py`` (``pcg`` with its three loop
formulations, ``pcg_mixed``, ``refine_tol``, ``PCGResult``, and their
blocked twins ``pcg_many`` and ``pcg_mixed_many`` for a block of
right-hand sides, held as (R, P, n_loc) with the column axis leading;
section "Blocked right-hand sides" below, with the resumable blocked
carry, ``select_best_many`` and the per-column ladder's
``restart_carry_many``).  The JAX
package runs the loop as one ``lax.while_loop`` whose decisions are
traced ``cond``/``where``; here the host drives the loop and branches on
scalars.  Each trip's vector work is queued on the device first and its
reductions come back in ONE host read; every decision is then taken on
the host in numpy scalars of the reduction (dot) dtype, so comparisons,
square roots and divisions round exactly as the device program's would.

Flags: 0 converged; 1 max-iterations; 2 inf preconditioner; 3 stagnation /
tolerance too small; 4 rho/pq breakdown; 6 sustained residual drift of a
recurrence variant (``DRIFT_FLAG``); 5 a quarantined column of a blocked
solve (``QUARANTINE_FLAG``).

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

import contextlib
import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from pcg_mpi_solver_tpu_torch.config import PCG_VARIANTS
from pcg_mpi_solver_tpu_torch.ops.matvec import Ops

# Flags that mean the Krylov recurrence collapsed, not that the system is
# unsolvable: a restart from the min-residual iterate routinely completes
# the solve (the recovery ladder, resilience/engine.py).  Flags 1 and 3
# are not in the set, and a NaN carry trips no flag at all (the chunked
# budget loop, solver/chunked.py, detects it).
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
    # blocked solves (pcg_many, pcg_mixed_many): the lockstep trips, one
    # blocked storage-dtype matvec each
    trips: int = 0


# The profiler ranges of a trip's phases (``obs/profview.PHASE_SCOPES``):
# entered only while a profiler capture is on; otherwise every scope is
# this one shared null context.
_NO_RANGE = contextlib.nullcontext()


def _no_range(_name: str):
    return _NO_RANGE


def phase_scopes():
    """``scope(name)`` for the phase ranges ``pcg/matvec``,
    ``pcg/precond``, ``pcg/reduce`` and ``pcg/axpy``: a
    ``torch.profiler.record_function`` range while a profiler capture is
    on (decided once a call), else a shared null context."""
    if torch.autograd._profiler_enabled():
        from torch.profiler import record_function

        return record_function
    return _no_range


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


def _host(v):
    """A carry scalar as a host number: 0-d tensors and arrays, numpy
    scalars and Python numbers alike (a snapshot restores numpy)."""
    return v.item() if isinstance(v, torch.Tensor) else np.asarray(v).item()


def cold_carry(x0: torch.Tensor, r0: torch.Tensor, normr0,
               dot_dtype: torch.dtype, variant: str = "classic") -> dict:
    """The cold carry of a resumable ``pcg`` call (``carry_in``), with the
    JAX package's key set (``pcg_mpi_solver_tpu/solver/pcg.py:177-240``):
    vectors are tensors, the scalars host numbers (``rho``, ``alpha`` and
    the norms numpy scalars of the dot dtype, counters ints).  p = 0 and
    rho = 1 make the first resumed trip the textbook first CG step; the
    recurrence variants add q = 0, alpha = inf (which zeroes the
    denominator's correction), the ``fresh`` gate and the drift count;
    pipelined the four GV vectors, the armed priming bit and the
    replacement cadence.  ``since_best``, ``best_at_reset``,
    ``win_start`` and ``win_count`` are the plateau and progress windows'
    state (ROADMAP queue 1 item 3): tracked, and read by nothing while
    the windows are off."""
    f = _np_type(dot_dtype)
    n0 = f(_host(normr0))
    out = dict(x=x0, r=r0, p=torch.zeros_like(x0), rho=f(1), stag=0,
               moresteps=0, normrmin=n0, xmin=x0, imin=0, since_best=0,
               best_at_reset=n0, win_start=n0, win_count=0, normr_act=n0,
               exec=0)
    if variant in LAGGED_VARIANTS:
        out.update(q=torch.zeros_like(x0), alpha=f(np.inf), fresh=1,
                   drift=0)
    if variant == "pipelined":
        out.update({k: torch.zeros_like(x0) for k in ("u", "w", "s", "z")})
        out.update(init=1, sc=0)
    return out


def select_best(ops: Ops, data: dict, fext: torch.Tensor, carry: dict,
                always_min: bool = False):
    """Min-residual fallback of a terminally failed resumable solve (JAX
    ``solver/pcg.py:281-307``): (x, relres) of whichever of the carry's
    last iterate and its min-residual iterate has the smaller residual,
    the latter's recomputed (one matvec and ONE read).  ``always_min``
    (the recurrence variants, whose last iterate was never evaluated):
    the min-residual iterate unconditionally.  ``relres`` is a host
    scalar of the dot dtype."""
    eff = data["eff"]
    w = data["weight"] * eff
    f = _np_type(ops.dot_dtype)
    r_min = fext - eff * ops.matvec(data, carry["xmin"])
    v = _read(ops.wdot(w, fext, fext), ops.wdot(w, r_min, r_min))
    n2b, normr_min = np.sqrt(f(v[0])), np.sqrt(f(v[1]))
    den = max(n2b, f(np.finfo(np.float32).tiny))
    if always_min:
        return carry["xmin"], normr_min / den
    use_min = bool(normr_min < f(carry["normr_act"]))
    return ((carry["xmin"], normr_min / den) if use_min
            else (carry["x"], f(carry["normr_act"]) / den))


def mixed_windows(scfg) -> dict:
    """The mixed shell's window options of a ``SolverConfig`` as the
    keywords of ``pcg`` / ``pcg_many`` (their inner f32 cycles only)."""
    return dict(plateau_window=scfg.mixed_plateau_window,
                progress_window=scfg.mixed_progress_window,
                progress_ratio=scfg.mixed_progress_ratio,
                progress_min_gain=scfg.mixed_progress_min_gain)


def refine_tol(tolb, normr, inner_tol) -> np.float32:
    """Adaptive inner tolerance for one mixed-precision refinement cycle:
    the final cycle only needs to contract the residual by tolb/normr — a
    fixed inner_tol would overshoot the outer tolerance.  Computed in the
    precision of ``tolb``/``normr``, returned as float32; elementwise on
    the (R,) arrays of a blocked solve."""
    f = np.asarray(tolb).dtype.type
    with np.errstate(divide="ignore", invalid="ignore"):
        # a zero-rhs column (tolb = normr = 0) takes no inner cycle
        val = f(0.5) * tolb / np.maximum(normr, tolb * f(1e-30))
    return np.float32(np.minimum(np.maximum(val, f(inner_tol)), f(0.25)))


@dataclasses.dataclass
class _Carry:
    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    rho: object               # 0-d dot-dtype tensor on the device (classic,
                              # fused); numpy scalar (pipelined)
    rho_h: object             # rho on the host (dot dtype)
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
    # the plateau and progress windows' state (cold_carry), carried
    since_best: int = 0
    best_at_reset: object = None
    win_start: object = None
    win_count: int = 0
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
    carry_in: Optional[dict] = None,
    return_carry: bool = False,
    x0_zero: bool = False,
    variant: str = "classic",
    plateau_window: int = 0,
    progress_window: int = 0,
    progress_ratio: float = 0.7,
    progress_min_gain: float = 30.0,
    trace_in=None,
    trace_scale=None,
):
    """Returns PCGResult, or (PCGResult, carry) with ``return_carry``.

    ``return_carry`` skips the min-residual finalize and returns the raw
    continuation state with :func:`cold_carry`'s keys (the last iterate,
    the tracked min-residual iterate and norms, the recurrence state of a
    lagged variant, and ``exec``, the executed trip count that the
    budget loops count with).  ``carry_in`` resumes from such a carry
    (it overrides ``x0`` and the initial-residual matvec), so capped
    calls in sequence are bit for bit one long solve: the loop never
    exits with a deferred check pending (a candidate trip does not
    advance ``i``, so its check runs in the same call), and ``i``,
    ``iter_out`` and ``imin`` count from 0 in each call, as in the JAX
    package.  ``x0_zero`` declares ``x0`` all zeros, so r0 = fext and
    ||r0|| = ||fext|| without a matvec.  ``max_iter_nominal`` sets the
    MoreSteps budget when ``max_iter`` is a remaining-iterations cap.
    ``variant`` is one of ``VALID_PCG_VARIANTS`` (module docstring).

    The mixed shell's two extra flag-3 exits (the JAX package's ``pcg``
    :362-395; both off at 0, as for every direct solve):
    ``plateau_window`` > 0 exits when no 0.1 % better residual than at
    the window's last reset came for that many iterations;
    ``progress_window`` > 0 compares, every that many iterations, the
    monotone min residual with its value a window ago and exits when the
    window contracted it by less than 1 / ``progress_ratio`` after the
    cycle already contracted ||fext|| by ``progress_min_gain``.  Their
    clocks ride the carry (``since_best``, ``best_at_reset``,
    ``win_start``, ``win_count``), so capped calls resume them exactly;
    a check forced by the pipelined cadence alone does not tick them.

    ``trace_in`` (an ``obs/trace.py`` ring) records (normr, rho, stag,
    flag) once per committed iteration, as the JAX package's ring does
    (its slots: the epilogue of an iterate, immediate or by the deferred
    check with the true residual, and the breakdown trip with its dying
    flag; a lagged trip right after a failed check resolves no new
    iterate and records nothing), in place: capped calls in sequence
    pass the same ring.  ``trace_scale`` rescales the recorded norms (a
    mixed inner cycle iterates on r / ||r||: scale = ||r||).  A record
    is a host row write, never a device operation or a read."""
    if variant not in VALID_PCG_VARIANTS:
        raise ValueError(f"pcg variant must be one of "
                         f"{VALID_PCG_VARIANTS}, got {variant!r}")
    warm = carry_in is not None
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
    scope = phase_scopes()
    ring = trace_in

    def record(normr, rho_h, stag, flag):
        if ring is not None:
            ring.record(normr, rho_h, stag, flag, trace_scale)

    # MATLAB: maxmsteps = min([floor(n/50), 5, n-maxit])
    nominal = max_iter_nominal if max_iter_nominal is not None else max_iter
    maxmsteps = min(glob_n_dof_eff // 50, 5, glob_n_dof_eff - nominal)

    with scope("pcg/reduce"):
        n2b = np.sqrt(f(_read(ops.wdot(w, fext, fext))[0]))
    tolb = f(tol) * n2b

    def amul(v):
        """Assembled K.v restricted to effective dofs."""
        with scope("pcg/matvec"):
            return eff * ops.matvec(data, v)

    if warm:
        x0, r0 = carry_in["x"], carry_in["r"]
        normr0 = f(_host(carry_in["normr_act"]))
    elif x0_zero:
        r0, normr0 = fext, n2b
    else:
        r0 = fext - amul(x0)
        with scope("pcg/reduce"):
            normr0 = np.sqrt(f(_read(ops.wdot(w, r0, r0))[0]))

    zero_rhs = bool(n2b == 0)
    # a resumed recurrence variant's norm is its predecessor iterate's
    # (the lag): never flag 0 the unevaluated resumed iterate off it
    initial_ok = False if (warm and lagged) else bool(normr0 <= tolb)
    st = carry_in if warm else cold_carry(x0, r0, normr0, dd, variant)

    def dev_scalar(v):
        return torch.tensor(_host(v), dtype=dd, device=fext.device)

    c = _Carry(x=x0, r=r0, p=st["p"], rho=dev_scalar(st["rho"]),
               rho_h=f(_host(st["rho"])), i=0,
               flag=0 if (zero_rhs or initial_ok) else 1,
               stag=int(_host(st["stag"])),
               moresteps=int(_host(st["moresteps"])), iter_out=0,
               normr_act=normr0, normrmin=f(_host(st["normrmin"])),
               xmin=st["xmin"], imin=int(_host(st["imin"])), mode=0,
               since_best=int(_host(st["since_best"])),
               best_at_reset=f(_host(st["best_at_reset"])),
               win_start=f(_host(st["win_start"])),
               win_count=int(_host(st["win_count"])))
    if lagged:
        # cold values make the first trip the textbook first CG step:
        # p = q = 0 collapse the recurrences, and alpha_prev = inf zeroes
        # the denominator's correction (beta*rho/inf == 0)
        c.q = st["q"]
        c.alpha = dev_scalar(st["alpha"])
        c.alpha_h = f(_host(st["alpha"]))
        c.fresh, c.drift = int(_host(st["fresh"])), int(_host(st["drift"]))
        c.chk_normr = f(0)
    if pipelined:
        c.u, c.w, c.s, c.z = (st[k] for k in ("u", "w", "s", "z"))
        c.init, c.sc = int(_host(st["init"])), int(_host(st["sc"]))
        c.rho = f(_host(st["rho"]))
        early = _EarlyRead(fext.device, 6)

    def resolve(x, r, p, rho, rho_h, stag, normr_act, candidate,
                advance=True, extra=None, tick=True, rec=True):
        """Iteration epilogue: stag reset / MoreSteps / min-residual
        bookkeeping and the flag decision; ``candidate`` marks a
        true-residual check (then ``normr_act`` is the recomputed actual
        residual norm, else the recurrence norm).  ``extra`` sets carry
        fields AFTER the bookkeeping: a lagged trip tracks the min
        residual against the lagged iterate ``x`` while it commits the
        fresh update.  ``advance=False`` keeps ``i`` (a lagged check
        committed no update).  ``tick=False`` (a check forced by the
        pipelined cadence alone) freezes the windows' clocks and their
        verdicts.  ``rec=False`` (a lagged trip whose iterate a failed
        check already resolved) writes no trace record."""
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
        live = not converged and not toosmall
        plateaued = no_progress = False
        if tick:
            # the plateau window's clock: a 0.1 % better residual than at
            # its last reset restarts it
            if normr_act < c.best_at_reset * f(1 - 1e-3):
                c.since_best, c.best_at_reset = 0, normr_act
            else:
                c.since_best += 1
            plateaued = bool(plateau_window) and live \
                and c.since_best > plateau_window
            if progress_window:
                # the progress window rolls over when it elapses
                c.win_count += 1
                if c.win_count >= progress_window:
                    no_progress = live and bool(
                        c.normrmin > f(progress_ratio) * c.win_start
                        and c.normrmin * f(progress_min_gain) < n2b)
                    c.win_start, c.win_count = c.normrmin, 0
        stagnated = stag >= max_stag_steps and live
        c.flag = 0 if converged else 3 if (
            toosmall or stagnated or plateaued or no_progress) else 1
        if rec:
            record(normr_act, rho_h, stag, c.flag)
        c.x, c.r, c.p, c.rho, c.rho_h, c.stag = x, r, p, rho, rho_h, stag
        c.iter_out = i
        c.i = i if (c.flag != 1 or not advance) else i + 1
        c.normr_act = normr_act
        c.mode = 0
        for k, v in (extra or {}).items():
            setattr(c, k, v)

    def true_norm(x):
        """(fext - A.x, its norm): the deferred check's actual residual."""
        kx = amul(x)
        with scope("pcg/reduce"):
            r_true = fext - kx
            return r_true, np.sqrt(f(_read(ops.wdot(w, r_true, r_true))[0]))

    def classic_check():
        # recompute the ACTUAL residual of the committed iterate before
        # declaring convergence
        r_true, normr_act = true_norm(c.x)
        resolve(c.x, r_true, c.p, c.rho, c.rho_h, c.stag, normr_act, True)

    def classic_trip():
        i = c.i
        with scope("pcg/precond"):
            z = ops.apply_prec(inv_diag, c.r, data)
        with scope("pcg/reduce"):
            inf_loc = torch.isinf(z).any()
            red = ops.wdots(w, [(z, c.r)], extra=[inf_loc])
            rho = red[0]
            beta = (rho / c.rho).to(dt)
        # a resumed call continues the direction recurrence on its first
        # trip (and tests its beta there)
        first = i == 0 and not warm
        with scope("pcg/axpy"):
            p = z if first else z + beta * c.p
        q = amul(p)
        with scope("pcg/reduce"):
            pq = ops.wdot(w, p, q)
            alpha = (rho / pq).to(dt)
        with scope("pcg/axpy"):
            r = c.r - alpha * q
        with scope("pcg/reduce"):
            sq = ops.wdots(w, [(p, p), (c.x, c.x), (r, r)])
            v = _read(rho, red[1], beta, pq, alpha, sq[0], sq[1], sq[2])
        rho_h, beta_h, pq_h, alpha_h = f(v[0]), fs(v[2]), f(v[3]), fs(v[4])
        flag2 = bool(v[1] > 0)
        breakdown = (rho_h == 0 or np.isinf(rho_h)
                     or (not first and (beta_h == 0 or np.isinf(beta_h)))
                     or pq_h <= 0 or np.isinf(pq_h) or np.isinf(alpha_h))
        if flag2 or breakdown:
            c.flag = 2 if flag2 else 4
            c.iter_out = i
            # the dying trip's record: the last norm, this trip's rho
            record(c.normr_act, rho_h, c.stag, c.flag)
            c.rho, c.rho_h = rho, rho_h
            return

        normp, normx, normr = (np.sqrt(f(v[5])), np.sqrt(f(v[6])),
                               np.sqrt(f(v[7])))
        stag = c.stag + 1 if normp * f(abs(alpha_h)) < eps * normx else 0
        with scope("pcg/axpy"):
            x = c.x + alpha * p
        candidate = (normr <= tolb or stag >= max_stag_steps
                     or c.moresteps > 0)
        if candidate:
            # COMMIT the iterate but defer the epilogue to the next trip's
            # true-residual check; i, flag and the bookkeeping wait
            c.x, c.r, c.p, c.rho, c.rho_h, c.stag = x, r, p, rho, rho_h, stag
            c.iter_out = i
            c.mode = 1
        else:
            resolve(x, r, p, rho, rho_h, stag, normr, False)

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
            c.rho_h = rho_h
            record(normr, rho_h, stag, c.flag)
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
        natural = c.chk_forced == 0
        resolve(c.x, r_true, c.p, c.rho, c.rho_h, c.stag, normr_act,
                natural, advance=False, extra=extra, tick=natural)
        if c.flag == 1 and drift >= drift_limit:
            c.flag = DRIFT_FLAG

    def fused_trip():
        i = c.i
        with scope("pcg/precond"):
            z = ops.apply_prec(inv_diag, c.r, data)
        wz = amul(z)
        with scope("pcg/reduce"):
            inf_loc = torch.isinf(z).any()
            red = ops.wdots(w, [(c.r, z), (z, wz), (c.r, c.r), (c.p, c.p),
                                (c.x, c.x)], extra=[inf_loc])
            rho, mu = red[0], red[1]
            # Chronopoulos–Gear scalars on the device, in the dot dtype
            beta = rho / c.rho
            pq = mu - beta * rho / c.alpha
            alpha = rho / pq
        # the update, queued speculatively (dropped on a candidate trip)
        with scope("pcg/axpy"):
            beta_dt, alpha_dt = beta.to(dt), alpha.to(dt)
            p = z + beta_dt * c.p
            q = wz + beta_dt * c.q
            x = c.x + alpha_dt * p
            r = c.r - alpha_dt * q
        with scope("pcg/reduce"):
            v = _read(red, beta, pq, alpha)
        normr, normp, normx = (np.sqrt(f(v[2])), np.sqrt(f(v[3])),
                               np.sqrt(f(v[4])))
        flag2 = bool(v[5] > 0)
        already, stag, natural = lagged_stag(normr, normp, normx)
        alpha_h = f(v[8])
        if lagged_stop(i, (f(v[0]), f(v[6]), f(v[7]), alpha_h), rho, stag,
                       normr, flag2, natural and not already):
            return
        resolve(c.x, c.r, c.p, rho, f(v[0]), stag, normr, False,
                extra=dict(x=x, r=r, p=p, q=q, alpha=alpha, alpha_h=alpha_h,
                           fresh=1), rec=not already)

    def pipelined_trip():
        i = c.i
        if c.init:
            # priming: u0 = M^-1.r0, w0 = A.u0; nothing else is committed
            with scope("pcg/precond"):
                c.u = ops.apply_prec(inv_diag, c.r, data)
            c.w = amul(c.u)
            c.init = 0
            return
        # the ONE reduction, on carry leaves only, queued first and read
        # back while the trip's preconditioner and stencil run
        with scope("pcg/reduce"):
            inf_loc = torch.isinf(c.u).any()
            red = ops.wdots(w, [(c.r, c.u), (c.w, c.u), (c.r, c.r),
                                (c.p, c.p), (c.x, c.x)], extra=[inf_loc])
            early.start(red)
        with scope("pcg/precond"):
            m = ops.apply_prec(inv_diag, c.w, data)
        km = amul(m)
        with scope("pcg/reduce"):
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
        with scope("pcg/axpy"):
            p = c.u + b * c.p           # p = 0 cold => p = u
            s = c.w + b * c.s           # A.p by recurrence
            q = m + b * c.q             # M^-1.s by recurrence
            z = km + b * c.z            # A.q by recurrence
            upd = dict(x=c.x + a * p, r=c.r - a * s, p=p, s=s, q=q, z=z,
                       u=c.u - a * q, w=c.w - a * z)
        resolve(c.x, c.r, c.p, gamma, gamma, stag, normr, False,
                extra=dict(upd, alpha_h=alpha, fresh=1, sc=c.sc + 1),
                rec=not already)

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
        carry = dict(x=c.x, r=c.r, p=c.p, rho=f(_host(c.rho)), stag=c.stag,
                     moresteps=c.moresteps, normrmin=c.normrmin,
                     xmin=c.xmin, imin=c.imin, since_best=c.since_best,
                     best_at_reset=c.best_at_reset, win_start=c.win_start,
                     win_count=c.win_count, normr_act=c.normr_act,
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
    plateau_window: int = 0,
    progress_window: int = 0,
    progress_ratio: float = 0.7,
    progress_min_gain: float = 30.0,
    trace_in=None,
) -> PCGResult:
    """Mixed-precision PCG by iterative refinement: f32 Krylov cycles on
    the NORMALIZED residual r/||r||, with the true residual recomputed and
    the solution accumulated in f64 at the top of every cycle.

    Exits: flag 0 when the f64 residual meets tol; 3 when a refinement
    cycle failed to halve it (stall); 2 after an inner inf-preconditioner
    exit; 1 when ``max_outer`` cycles or ``max_iter`` inner iterations are
    spent.  ``iters`` is the total of executed inner iterations.  The
    windows (``pcg``) run in every inner cycle.  ``trace_in`` (an
    ``obs/trace.py`` ring of float32) records the inner iterations,
    rescaled by each cycle's float64 refresh norm so the trace reads as
    absolute residuals across cycles."""
    eff64 = data64["eff"]
    w64 = data64["weight"] * eff64
    f = _np_type(ops64.dot_dtype)
    windows = dict(plateau_window=plateau_window,
                   progress_window=progress_window,
                   progress_ratio=progress_ratio,
                   progress_min_gain=progress_min_gain)

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
                trace_in=trace_in,
                trace_scale=normr,
                **windows,
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


# ---------------------------------------------------------------------------
# Blocked right-hand sides: pcg_many, pcg_mixed_many
# ---------------------------------------------------------------------------

# Terminal flag of a quarantined column of a blocked solve: on the one-shot
# path a column whose residual went non-finite without converging, and in
# Solver.solve_many every breakdown column (flags 2, 4, 6).  Its reported
# solution is the tracked min-residual iterate.
QUARANTINE_FLAG = 5


def _colsel(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor
            ) -> torch.Tensor:
    """Per-column select: ``mask`` (R,) over blocks (R, P, n_loc) or over
    (R,) device scalars."""
    return torch.where(mask.reshape(-1, *[1] * (a.dim() - 1)), a, b)


class _Masks:
    """The per-column boolean masks of one blocked trip, held on the host
    and uploaded together: ONE copy from pinned memory, non-blocking (not
    a sync), and none at all when every mask is all-true or all-false,
    where :meth:`sel` picks a side without a device select."""

    def __init__(self, device: torch.device, **masks):
        self.host = {k: np.asarray(m, bool) for k, m in masks.items()}
        mixed = [k for k, m in self.host.items() if m.any() and not m.all()]
        self.dev = {}
        if mixed:
            t = torch.from_numpy(np.stack([self.host[k] for k in mixed]))
            if device.type == "cuda":
                t = t.pin_memory().to(device, non_blocking=True)
            self.dev = {k: t[j] for j, k in enumerate(mixed)}

    def sel(self, key: str, a, b):
        """``a`` on the columns of mask ``key``, ``b`` elsewhere; ``a`` and
        ``b`` may be callables, evaluated only when their side is taken."""
        m = self.host[key]
        if m.all():
            return a() if callable(a) else a
        if not m.any():
            return b() if callable(b) else b
        return _colsel(self.dev[key], a() if callable(a) else a,
                       b() if callable(b) else b)


def _read_rows(R: int, *ts: torch.Tensor) -> np.ndarray:
    """ONE device->host read of (R,) and (k, R) tensors: (rows, R) float64."""
    return _read(*ts).reshape(-1, R)


def cold_carry_many(x0: torch.Tensor, r0: torch.Tensor, normr0,
                    dot_dtype: torch.dtype, variant: str = "classic"
                    ) -> dict:
    """The cold carry of a resumable blocked solve (``pcg_many``'s
    ``carry_in``), with the JAX package's key set
    (``pcg_mpi_solver_tpu/solver/pcg.py:1425-1461``): x0 and r0 are (R, P,
    n_loc) blocks, every other leaf an (R,) host numpy array (the norms,
    ``rho`` and ``alpha`` in the dot dtype, counters int64).  Every column
    starts running (``flag`` 1) under the primary preconditioner
    (``prec_sel`` 0); p = 0 and rho = 1 make the first trip the textbook
    first CG step, and the recurrence variants add q = 0, alpha = inf,
    the ``fresh`` gate and the drift count, pipelined the four GV vectors
    and the armed priming bit."""
    R = x0.shape[0]
    f = _np_type(dot_dtype)
    zi = np.zeros(R, np.int64)
    n0 = np.asarray(normr0, f)
    out = dict(
        x=x0, r=r0, p=torch.zeros_like(x0), rho=np.ones(R, f),
        stag=zi.copy(), moresteps=zi.copy(), normrmin=n0.copy(), xmin=x0,
        imin=zi.copy(), since_best=zi.copy(), best_at_reset=n0.copy(),
        win_start=n0.copy(), win_count=zi.copy(), normr_act=n0.copy(),
        exec=zi.copy(), flag=np.ones(R, np.int64), prec_sel=zi.copy())
    if variant in LAGGED_VARIANTS:
        out.update(q=torch.zeros_like(x0), alpha=np.full(R, np.inf, f),
                   fresh=np.ones(R, np.int64), drift=zi.copy())
    if variant == "pipelined":
        out.update({k: torch.zeros_like(x0) for k in ("u", "w", "s", "z")})
        out.update(init=np.ones(R, np.int64), sc=zi.copy())
    return out


_INT_LEAVES = ("stag", "moresteps", "imin", "since_best", "win_count",
               "flag", "prec_sel", "exec", "fresh", "drift", "init", "sc")
_NORM_LEAVES = ("normrmin", "best_at_reset", "win_start", "normr_act")


def _loop_state(carry: dict, dot_dtype: torch.dtype, variant: str) -> dict:
    """``pcg_many``'s loop state from a carry (cold or resumed): host
    copies of the (R,) leaves, the recurrence scalars rho and alpha as
    device tensors built from their host values bit for bit (with host
    mirrors ``rho_h`` and ``alpha_h``), and the per-call counters ``i``,
    ``iter_out`` and ``mode`` at 0."""
    f = _np_type(dot_dtype)
    dev = carry["x"].device
    R = carry["x"].shape[0]
    zi = np.zeros(R, np.int64)
    c = {k: carry[k] for k in ("x", "r", "p", "xmin")}
    for k in _INT_LEAVES:
        if k in carry:
            c[k] = np.array(carry[k], np.int64).reshape(R)
    for k in _NORM_LEAVES:
        c[k] = np.array(carry[k], f).reshape(R)
    c["rho_h"] = np.array(carry["rho"], f).reshape(R)
    c["rho"] = torch.as_tensor(c["rho_h"].copy(), device=dev)
    c.update(i=zi.copy(), iter_out=zi.copy(), mode=zi.copy())
    if variant in LAGGED_VARIANTS:
        c["q"] = carry["q"]
        c["alpha_h"] = np.array(carry["alpha"], f).reshape(R)
        c["alpha"] = torch.as_tensor(c["alpha_h"].copy(), device=dev)
        c["chk_normr"] = np.zeros(R, f)
    if variant == "pipelined":
        c.update({k: carry[k] for k in ("u", "w", "s", "z")})
        c["chk_forced"] = zi.copy()
    return c


def pcg_many(
    ops: Ops,
    data: dict,
    fext: torch.Tensor,       # (R, P, n_loc) rhs block on eff dofs
    x0: torch.Tensor,         # (R, P, n_loc) initial guesses
    inv_diag,                 # preconditioner operand, shared by columns
    tol,                      # scalar or (R,) per-column tolerance
    max_iter,                 # int or (R,) per-column budget
    glob_n_dof_eff: int,
    max_stag_steps: int = 3,
    max_iter_nominal: Optional[int] = None,
    carry_in: Optional[dict] = None,
    return_carry: bool = False,
    x0_zero: bool = False,
    variant: str = "classic",
    inv_diag_fb=None,
    plateau_window: int = 0,
    progress_window: int = 0,
    progress_ratio: float = 0.7,
    progress_min_gain: float = 30.0,
):
    """Blocked ``pcg``: K.x_j = fext_j for every column j of the block in
    ONE lockstep loop.  ``data`` is the tree of
    ``parallel.structured.block_data`` for this width.  Returns a
    PCGResult whose ``x`` is (R, P, n_loc) and whose flag, relres and
    iters are (R,) numpy arrays, or (result, carry) with
    ``return_carry``: the raw carry, :func:`cold_carry_many`'s keys, with
    ``exec`` the per-column executed iterations (0 for a column frozen at
    entry).  ``carry_in`` resumes from such a carry (it overrides ``x0``):
    a column whose carry flag is not 1 stays frozen, and capped calls in
    sequence are, column by column, bit for bit one long solve, since a
    column's deferred check runs in the call that made it a candidate.
    ``inv_diag_fb``, the scalar-Jacobi fallback operand of the recovery
    ladder, preconditions the columns whose carry ``prec_sel`` is set;
    the others keep ``inv_diag``, and their bits.

    Each column keeps ``pcg``'s semantics: its own mode-0 iterate /
    mode-1 deferred-check sequence, stagnation, MoreSteps, min-residual
    bookkeeping, plateau and progress windows and flag taxonomy; a column
    that stops (converged, broken down, out of budget) freezes while the
    others iterate.  A trip runs
    ONE blocked matvec (check columns put x in its operand, iterate
    columns their direction), queues every reduction of the trip, reads
    them back in ONE host read, takes each column's decision on the host
    in numpy, and commits through per-column selects against masks
    uploaded once a trip (:class:`_Masks`).  Under fused the speculative
    update is queued before the read; under pipelined the reduction is
    read early (:class:`_EarlyRead`) while the preconditioner and the
    stencil run, and a trip with a deferred check reads its true residual
    after them.

    Finalize: a failed column returns its min-residual iterate (lagged
    variants unconditionally), a zero-rhs column zeros with flag 0 and 0
    iterations, and on the one-shot path a non-converged column whose
    residual went non-finite ``QUARANTINE_FLAG``."""
    if variant not in VALID_PCG_VARIANTS:
        raise ValueError(f"pcg variant must be one of "
                         f"{VALID_PCG_VARIANTS}, got {variant!r}")
    lagged = variant in LAGGED_VARIANTS
    pipelined = variant == "pipelined"
    drift_limit = drift_limit_for(variant)
    dd = ops.dot_dtype
    dt = fext.dtype
    dev = fext.device
    f = _np_type(dd)          # host scalars in the dot dtype
    fs = _np_type(dt)         # host scalars in the storage dtype
    R = fext.shape[0]
    eff = data["eff"]
    w = data["weight"] * eff
    eps = f(np.finfo(fs).eps)
    max_iter = np.broadcast_to(np.asarray(max_iter, np.int64), (R,))

    nominal = max_iter_nominal if max_iter_nominal is not None else max_iter
    maxmsteps = np.minimum(min(glob_n_dof_eff // 50, 5),
                           glob_n_dof_eff - np.asarray(nominal, np.int64))

    def norms(*ts):
        """sqrt of squared norms read back, in the dot dtype."""
        return np.sqrt(_read_rows(R, *ts).astype(f))

    n2b = norms(ops.wdot_many(w, fext, fext))[0]
    tolb = np.asarray(tol, f) * n2b

    def amul(v):
        """Assembled K.v restricted to effective dofs."""
        return eff * ops.matvec(data, v)

    warm = carry_in is not None
    frozen0 = np.zeros(R, bool)
    if warm:
        x0, r0 = carry_in["x"], carry_in["r"]
        normr0 = np.asarray(carry_in["normr_act"], f)
        frozen0 = np.asarray(carry_in["flag"]) != 1
    elif x0_zero:
        r0, normr0 = fext, n2b
    else:
        r0 = fext - amul(x0)
        normr0 = norms(ops.wdot_many(w, r0, r0))[0]

    zero_rhs = n2b == 0
    # a resumed recurrence variant's norm is its predecessor iterate's
    # (the lag): never flag 0 the unevaluated resumed iterate off it
    initial_ok = (np.zeros(R, bool) if (warm and lagged)
                  else normr0 <= tolb)
    c = _loop_state(carry_in if warm
                    else cold_carry_many(x0, r0, normr0, dd, variant),
                    dd, variant)
    c["flag"] = np.where(zero_rhs | initial_ok, 0, c["flag"])
    if pipelined:
        early = _EarlyRead(dev, 6 * R)
    # the ladder's per-column fallback: prec_sel is fixed for the call
    on_fb = np.asarray(c["prec_sel"]) > 0
    fb_masks = (_Masks(dev, fb=on_fb)
                if inv_diag_fb is not None and on_fb.any() else None)

    def precond(src):
        """M^-1 src: the primary operand, and the fallback on the columns
        the ladder moved to it."""
        if fb_masks is None:
            return ops.apply_prec(inv_diag, src, data)
        return fb_masks.sel(
            "fb", lambda: ops.apply_prec(inv_diag_fb, src, data),
            lambda: ops.apply_prec(inv_diag, src, data))

    def active():
        return (c["flag"] == 1) & (c["i"] < max_iter)

    def pre_masks():
        """The masks a trip needs before its read: deferred-check
        columns, first iterations (classic), priming sources (pipelined)."""
        m = dict(chk=(c["mode"] == 1) & active())
        if variant == "classic":
            # a resumed call continues the direction recurrence on its
            # first trip (and tests its beta there)
            m["i0"] = (c["i"] == 0) & (not warm)
        if pipelined:
            m["init"] = c["init"] > 0
        return m

    def resolve(normr_act, candidate, stag, i, tick=True):
        """Per-column iteration epilogue (``pcg``'s ``resolve``): the
        stag reset, MoreSteps, min-residual bookkeeping, the plateau and
        progress windows' clocks (frozen, with their verdicts, where
        ``tick`` is False: a check forced by the pipelined cadence alone)
        and the flag, as (R,) arrays;
        ``better`` marks columns whose min-residual iterate moves to the
        resolved one."""
        candidate = np.broadcast_to(candidate, (R,))
        converged = candidate & (normr_act <= tolb)
        failed = candidate & ~converged
        stag = np.where(failed & (stag >= max_stag_steps)
                        & (c["moresteps"] == 0), 0, stag)
        moresteps = np.where(failed, c["moresteps"] + 1, c["moresteps"])
        toosmall = failed & (moresteps >= maxmsteps)
        better = normr_act < c["normrmin"]
        normrmin = np.where(better, normr_act, c["normrmin"])
        improved = normr_act < c["best_at_reset"] * f(1 - 1e-3)
        tick = np.broadcast_to(tick, (R,))
        live = ~converged & ~toosmall
        since_best = np.where(tick, np.where(improved, 0,
                                             c["since_best"] + 1),
                              c["since_best"])
        best_at_reset = np.where(tick & improved, normr_act,
                                 c["best_at_reset"])
        plateaued = (tick & live & (since_best > plateau_window)
                     if plateau_window else np.zeros(R, bool))
        win_start, win_count = c["win_start"], c["win_count"]
        no_progress = np.zeros(R, bool)
        if progress_window:
            count = win_count + 1
            at_window = tick & (count >= progress_window)
            no_progress = (at_window & live
                           & (normrmin > f(progress_ratio) * win_start)
                           & (normrmin * f(progress_min_gain) < n2b))
            win_start = np.where(at_window, normrmin, win_start)
            win_count = np.where(tick, np.where(at_window, 0, count),
                                 win_count)
        stagnated = (stag >= max_stag_steps) & live
        flag = np.where(converged, 0,
                        np.where(toosmall | stagnated | plateaued
                                 | no_progress, 3, 1))
        return dict(flag=flag, stag=stag, moresteps=moresteps,
                    normrmin=normrmin,
                    imin=np.where(better, i, c["imin"]),
                    i=np.where(flag != 1, i, i + 1), iter_out=i.copy(),
                    normr_act=np.asarray(normr_act, f),
                    since_best=since_best,
                    best_at_reset=np.asarray(best_at_reset, f),
                    win_start=np.asarray(win_start, f), win_count=win_count,
                    mode=np.zeros(R, np.int64), better=better)

    def merge(cases):
        """Per-column merge of the host outcomes: ``cases`` is a list of
        (mask, fields) with disjoint masks; other columns keep theirs."""
        for m, d in cases:
            for k, v in d.items():
                if k != "better":
                    c[k] = np.where(m, v, c[k])

    def breakdown_of(rho, beta, pq, alpha, first=False):
        """Per-column breakdown of the recurrence's scalars (classic's
        taxonomy); ``first`` columns (a classic first iteration, whose
        direction takes no beta) skip the beta test."""
        bad_beta = ~np.asarray(first) & ((beta == 0) | np.isinf(beta))
        return ((rho == 0) | np.isinf(rho) | bad_beta
                | (pq <= 0) | np.isinf(pq) | np.isinf(alpha))

    def check_norm(kop):
        """The deferred check's true residual fext - A.x and its squared
        norm (queued; ``kop`` is A.x on the check columns)."""
        r_true = fext - kop
        return r_true, ops.wdot_many(w, r_true, r_true)

    def drift_check(chk, normr_chk):
        """The drift guard of the lagged variants on the check columns'
        resolved fields ``chk``: a non-converged check whose true residual
        exceeds FUSED_DRIFT_FACTOR x the recurrence norm that prompted it
        counts one drift; at the variant's limit the column exits 6."""
        disagree = ((normr_chk > tolb)
                    & (normr_chk > f(FUSED_DRIFT_FACTOR) * c["chk_normr"]))
        drift = c["drift"] + disagree
        chk["drift"] = drift
        chk["flag"] = np.where((chk["flag"] == 1) & (drift >= drift_limit),
                               DRIFT_FLAG, chk["flag"])

    masks = _Masks(dev, **pre_masks())

    def commit(nxt, fields):
        """Device commits of one trip: ``fields`` maps a carry leaf to a
        list of (mask key, new value or callable) applied in order, the
        first matching mask winning; the masks are in ``nxt``."""
        for k, sources in fields.items():
            v = c[k]
            for key, new in reversed(sources):
                v = nxt.sel(key, new, v)
            c[k] = v

    def classic_trip():
        act = active()
        is_check = (c["mode"] == 1) & act
        it_m = act & ~is_check
        x, r, p = c["x"], c["r"], c["p"]
        z = precond(r)
        inf_col = torch.isinf(z).any(dim=(-2, -1))
        red = ops.wdots_many(w, [(z, r)], extra=[inf_col])
        rho_new = red[0]
        beta = (rho_new / c["rho"]).to(dt)
        p_new = masks.sel("i0", z, lambda: z + beta[:, None, None] * p)
        # the ONE blocked stencil application: check columns ride their
        # committed iterate through it (q_j = A.x_j there)
        q = amul(masks.sel("chk", x, p_new))
        pq = ops.wdot_many(w, p_new, q)
        alpha = (rho_new / pq).to(dt)
        r_upd = r - alpha[:, None, None] * q
        sq = ops.wdots_many(w, [(p_new, p_new), (x, x), (r_upd, r_upd)])
        x_upd = x + alpha[:, None, None] * p_new
        ts = [red, beta, pq, alpha, sq]
        if is_check.any():
            r_true, nchk = check_norm(q)
            ts.append(nchk)
        v = _read_rows(R, *ts)
        with np.errstate(all="ignore"):
            rho_h, flag2 = v[0].astype(f), v[1] > 0
            beta_h, pq_h, alpha_h = v[2].astype(fs), v[3].astype(f), \
                v[4].astype(fs)
            normp, normx, normr = np.sqrt(v[5:8].astype(f))
            breakdown = breakdown_of(rho_h, beta_h, pq_h, alpha_h,
                                     first=(c["i"] == 0) & (not warm))
            stag_upd = np.where(normp * np.abs(alpha_h).astype(f)
                                < eps * normx, c["stag"] + 1, 0)
            cand_new = ((normr <= tolb) | (stag_upd >= max_stag_steps)
                        | (c["moresteps"] > 0))
            new_flag = np.where(flag2, 2, 4)
            i = c["i"]
            res = resolve(normr, False, stag_upd, i)
            res["rho_h"] = rho_h
            stop = flag2 | breakdown
            m_brk = it_m & stop
            m_pend = it_m & ~stop & cand_new
            m_res = it_m & ~stop & ~cand_new
            cases = [(m_brk, dict(flag=new_flag, iter_out=i, rho_h=rho_h)),
                     (m_pend, dict(stag=stag_upd, iter_out=i, rho_h=rho_h,
                                   mode=np.ones(R, np.int64))),
                     (m_res, res)]
            chk_better = np.zeros(R, bool)
            if is_check.any():
                chk = resolve(np.sqrt(v[8].astype(f)), True, c["stag"], i)
                chk_better = is_check & chk["better"]
                cases.append((is_check, chk))
        upd = m_pend | m_res
        merge(cases)
        nxt = _Masks(dev, xmin_x=chk_better, xmin_upd=m_res & res["better"],
                     upd=upd, chk_r=is_check, rho=m_brk | upd,
                     **pre_masks())
        commit(nxt, dict(
            xmin=[("xmin_x", x), ("xmin_upd", x_upd)],
            x=[("upd", x_upd)],
            r=[("chk_r", lambda: r_true), ("upd", r_upd)],
            p=[("upd", p_new)],
            rho=[("rho", rho_new)]))
        return nxt

    def fused_trip():
        act = active()
        is_check = (c["mode"] == 1) & act
        it_m = act & ~is_check
        x, r, p = c["x"], c["r"], c["p"]
        z = precond(r)
        kop = amul(masks.sel("chk", x, z))  # A.z; A.x on check columns
        inf_col = torch.isinf(z).any(dim=(-2, -1))
        red = ops.wdots_many(w, [(r, z), (z, kop), (r, r), (p, p), (x, x)],
                             extra=[inf_col])
        rho, mu = red[0], red[1]
        # Chronopoulos–Gear scalars on the device, in the dot dtype
        beta = rho / c["rho"]
        pq = mu - beta * rho / c["alpha"]
        alpha = rho / pq
        # the update, queued speculatively (dropped on all but the
        # resolved columns)
        beta_dt = beta.to(dt)[:, None, None]
        alpha_dt = alpha.to(dt)[:, None, None]
        p2 = z + beta_dt * p
        q2 = kop + beta_dt * c["q"]
        x2 = x + alpha_dt * p2
        r2 = r - alpha_dt * q2
        ts = [red, beta, pq, alpha]
        if is_check.any():
            r_true, nchk = check_norm(kop)
            ts.append(nchk)
        v = _read_rows(R, *ts)
        i = c["i"]
        with np.errstate(all="ignore"):
            normr, normp, normx = np.sqrt(v[2:5].astype(f))
            flag2 = v[5] > 0
            already = c["fresh"] == 0
            small = normp * np.abs(c["alpha_h"]) < eps * normx
            stag = np.where(already, c["stag"],
                            np.where(small, c["stag"] + 1, 0))
            candidate = ((normr <= tolb) | (stag >= max_stag_steps)
                         | (c["moresteps"] > 0)) & ~already
            alpha_h = v[8].astype(f)
            rho_h = v[0].astype(f)
            breakdown = breakdown_of(rho_h, v[6].astype(f),
                                     v[7].astype(f), alpha_h)
            res = resolve(normr, False, stag, i)
            res.update(alpha_h=alpha_h, rho_h=rho_h,
                       fresh=np.ones(R, np.int64))
            m_brk = it_m & (flag2 | breakdown) & ~candidate
            m_pend = it_m & candidate
            m_res = it_m & ~candidate & ~(flag2 | breakdown)
            cases = [(m_brk, dict(flag=np.where(flag2, 2, 4), iter_out=i,
                                  rho_h=rho_h)),
                     (m_pend, dict(stag=stag, iter_out=i,
                                   mode=np.ones(R, np.int64),
                                   chk_normr=normr)),
                     (m_res, res)]
            chk_better = np.zeros(R, bool)
            if is_check.any():
                normr_chk = np.sqrt(v[9].astype(f))
                chk = resolve(normr_chk, True, c["stag"], i)
                chk.update(i=i, fresh=np.zeros(R, np.int64))
                drift_check(chk, normr_chk)
                chk_better = is_check & chk["better"]
                cases.append((is_check, chk))
        merge(cases)
        nxt = _Masks(dev, xmin=chk_better | (m_res & res["better"]),
                     upd=m_res, chk_r=is_check, rho=m_res | m_brk,
                     **pre_masks())
        commit(nxt, dict(
            xmin=[("xmin", x)], x=[("upd", x2)],
            r=[("chk_r", lambda: r_true), ("upd", r2)],
            p=[("upd", p2)], q=[("upd", q2)], alpha=[("upd", alpha)],
            rho=[("rho", rho)]))
        return nxt

    def pipelined_trip():
        act = active()
        is_check = (c["mode"] == 1) & act
        is_prime = (c["init"] > 0) & act & ~is_check
        it_m = act & ~is_check & ~is_prime
        x, r, p, u, wv = c["x"], c["r"], c["p"], c["u"], c["w"]
        # the ONE reduction, on carry leaves only, queued first and read
        # back while the trip's preconditioner and stencil run
        inf_col = torch.isinf(u).any(dim=(-2, -1))
        red = ops.wdots_many(w, [(r, u), (wv, u), (r, r), (p, p), (x, x)],
                             extra=[inf_col])
        early.start(red.reshape(-1))
        # priming columns precondition their residual, the others w
        m = precond(masks.sel("init", r, wv))
        kop = amul(masks.sel("chk", x, m))
        if it_m.any():
            # GV scalars on the device (the host takes the same IEEE
            # operations on the read values below) and the update, queued
            # speculatively
            gamma, delta = red[0], red[1]
            beta = gamma / c["rho"]
            alpha = gamma / (delta - beta * gamma / c["alpha"])
            b = beta.to(dt)[:, None, None]
            a = alpha.to(dt)[:, None, None]
            p2 = u + b * p              # p = 0 cold => p = u
            s2 = wv + b * c["s"]        # A.p by recurrence
            q2 = m + b * c["q"]         # M^-1.s by recurrence
            z2 = kop + b * c["z"]       # A.q by recurrence
            x2, r2 = x + a * p2, r - a * s2
            u2, w2 = u - a * q2, wv - a * z2
        if is_check.any():
            r_true, nchk = check_norm(kop)
        v = early.wait().reshape(-1, R)
        i = c["i"]
        with np.errstate(all="ignore"):
            gamma_h, delta_h = v[0].astype(f), v[1].astype(f)
            normr, normp, normx = np.sqrt(v[2:5].astype(f))
            flag2 = v[5] > 0
            already = c["fresh"] == 0
            small = normp * np.abs(c["alpha_h"]) < eps * normx
            stag = np.where(already, c["stag"],
                            np.where(small, c["stag"] + 1, 0))
            natural = ((normr <= tolb) | (stag >= max_stag_steps)
                       | (c["moresteps"] > 0))
            forced = c["sc"] >= PIPELINED_REPLACE_EVERY
            candidate = (natural | forced) & ~already
            beta_h = gamma_h / c["rho_h"]
            pq_h = delta_h - beta_h * gamma_h / c["alpha_h"]
            alpha_h = gamma_h / pq_h
            breakdown = breakdown_of(gamma_h, beta_h, pq_h, alpha_h)
            res = resolve(normr, False, stag, i)
            res.update(alpha_h=alpha_h, rho_h=gamma_h,
                       fresh=np.ones(R, np.int64), sc=c["sc"] + 1)
            m_brk = it_m & (flag2 | breakdown) & ~candidate
            m_pend = it_m & candidate
            m_res = it_m & ~candidate & ~(flag2 | breakdown)
            cases = [(is_prime, dict(init=np.zeros(R, np.int64))),
                     (m_brk, dict(flag=np.where(flag2, 2, 4), iter_out=i,
                                  rho_h=gamma_h)),
                     (m_pend, dict(stag=stag, iter_out=i,
                                   mode=np.ones(R, np.int64),
                                   chk_normr=normr,
                                   chk_forced=(forced & ~natural
                                               ).astype(np.int64))),
                     (m_res, res)]
            chk_better = np.zeros(R, bool)
            if is_check.any():
                # the deferred check with true-residual replacement: the
                # column re-primes u and w next trip; a check forced by
                # the cadence alone is no candidate
                normr_chk = np.sqrt(_read_rows(R, nchk)[0].astype(f))
                natural_chk = c["chk_forced"] == 0
                chk = resolve(normr_chk, natural_chk, c["stag"], i,
                              tick=natural_chk)
                chk.update(i=i, fresh=np.zeros(R, np.int64),
                           init=np.ones(R, np.int64),
                           sc=np.zeros(R, np.int64),
                           chk_forced=np.zeros(R, np.int64))
                drift_check(chk, normr_chk)
                chk_better = is_check & chk["better"]
                cases.append((is_check, chk))
        merge(cases)
        nxt = _Masks(dev, xmin=chk_better | (m_res & res["better"]),
                     upd=m_res, prime=is_prime, chk_r=is_check,
                     rho=m_res | m_brk, **pre_masks())
        commit(nxt, dict(
            xmin=[("xmin", x)], x=[("upd", lambda: x2)],
            r=[("chk_r", lambda: r_true), ("upd", lambda: r2)],
            p=[("upd", lambda: p2)], s=[("upd", lambda: s2)],
            q=[("upd", lambda: q2)], z=[("upd", lambda: z2)],
            u=[("upd", lambda: u2), ("prime", m)],
            w=[("upd", lambda: w2), ("prime", kop)],
            alpha=[("upd", lambda: alpha)],
            rho=[("rho", red[0])]))
        return nxt

    trip = {"classic": classic_trip, "fused": fused_trip,
            "pipelined": pipelined_trip}[variant]
    trips = 0
    while active().any():
        masks = trip()
        trips += 1

    # ---- finalize, per column: a failed column returns its min-residual
    # iterate where its true residual is the smaller one or its own went
    # non-finite (a lagged variant's last iterate was never evaluated, so
    # unconditionally there); return_carry returns the raw carry
    ok = c["flag"] == 0
    skip = zero_rhs | initial_ok | frozen0
    normr_min, use_min = c["normr_act"], np.zeros(R, bool)
    if not return_carry and (~ok & ~zero_rhs).any():
        r_min = fext - amul(c["xmin"])
        normr_min = norms(ops.wdot_many(w, r_min, r_min))[0]
        use_min = ~ok & (lagged | (normr_min < c["normr_act"])
                         | ~np.isfinite(c["normr_act"]))
    fin = _Masks(dev, use_min=use_min, zero=zero_rhs)
    x = fin.sel("zero", lambda: torch.zeros_like(c["x"]),
                lambda: fin.sel("use_min", c["xmin"], c["x"]))
    with np.errstate(divide="ignore", invalid="ignore"):
        relres = np.where(zero_rhs, 0.0,
                          np.where(use_min, normr_min, c["normr_act"]) / n2b
                          ).astype(np.float32)
    iters = np.where(skip, 0,
                     np.where(use_min, c["imin"], c["iter_out"]) + 1)
    flag = np.where(zero_rhs, 0, c["flag"])
    if not return_carry:
        # one-shot reporting: a non-finite residual trips no MATLAB flag;
        # the column already took its min-residual iterate above
        poisoned = ~np.isfinite(c["normr_act"]) & (flag != 0) & ~zero_rhs
        flag = np.where(poisoned, QUARANTINE_FLAG, flag)
    result = PCGResult(x=x, flag=flag, relres=relres, iters=iters,
                       trips=trips)
    if return_carry:
        keys = ["x", "r", "p", "stag", "moresteps", "normrmin", "xmin",
                "imin", "since_best", "best_at_reset", "win_start",
                "win_count", "normr_act", "prec_sel"]
        if lagged:
            keys += ["q", "fresh", "drift"]
        if pipelined:
            keys += ["u", "w", "s", "z", "init", "sc"]
        carry = {k: c[k] for k in keys}
        # the recurrence scalars leave as host values of the dot dtype,
        # equal to the device's bit for bit (a resume rebuilds them)
        carry["rho"] = c["rho_h"].copy()
        if lagged:
            carry["alpha"] = c["alpha_h"].copy()
        carry.update(flag=flag, exec=np.where(skip, 0, c["iter_out"] + 1))
        return result, carry
    return result


def select_best_many(ops: Ops, data: dict, fext: torch.Tensor, carry: dict,
                     always_min: bool = False):
    """The terminal per-column selection of a resumable blocked solve
    (JAX ``solver/pcg.py:1464-1502`` with ``respect_flags``): one blocked
    matvec and ONE read.  Converged columns (carry flag 0) keep their
    accepted iterate, zero-rhs columns return zeros, and a failed column
    takes its min-residual iterate where that residual is the smaller or
    its own is not finite (``always_min``, the recurrence variants:
    unconditionally).  Returns (x (R, P, n_loc), relres (R,) host
    float64)."""
    eff = data["eff"]
    w = data["weight"] * eff
    f = _np_type(ops.dot_dtype)
    R = fext.shape[0]
    r_min = fext - eff * ops.matvec(data, carry["xmin"])
    v = np.sqrt(_read_rows(R, ops.wdot_many(w, fext, fext),
                           ops.wdot_many(w, r_min, r_min)).astype(f))
    n2b, normr_min = v[0], v[1]
    den = np.maximum(n2b, f(np.finfo(np.float32).tiny))
    normr_act = np.asarray(carry["normr_act"], f)
    if always_min:
        use_min = np.ones(R, bool)
    else:
        use_min = (normr_min < normr_act) | ~np.isfinite(normr_act)
    ok = np.asarray(carry["flag"]) == 0
    use_min &= ~ok
    zero = n2b == 0
    relres = np.where(zero, f(0), np.where(use_min, normr_min, normr_act)
                      / den)
    sel = _Masks(fext.device, use_min=use_min, zero=zero)
    x = sel.sel("zero", lambda: torch.zeros_like(carry["x"]),
                lambda: sel.sel("use_min", carry["xmin"], carry["x"]))
    return x, relres.astype(np.float64)


def restart_carry_many(ops: Ops, data: dict, fext: torch.Tensor,
                       carry: dict, restart_mask, fallback_mask,
                       quarantine_mask, variant: str = "classic") -> dict:
    """Per-column recovery surgery on a blocked carry (JAX
    ``solver/pcg.py:1504-1566``): ``restart_mask`` columns get a cold
    Krylov carry at their min-residual iterate (one blocked matvec for the
    block), ``fallback_mask`` columns also move to the scalar-Jacobi
    fallback preconditioner (``prec_sel`` 1), ``quarantine_mask`` columns
    take the terminal ``QUARANTINE_FLAG``.  Every other column's leaves
    pass through bit for bit (per-column selects, never a rescale)."""
    eff = data["eff"]
    w = data["weight"] * eff
    f = _np_type(ops.dot_dtype)
    R = fext.shape[0]
    m = np.asarray(restart_mask, bool)
    xmin = carry["xmin"]
    r_new = fext - eff * ops.matvec(data, xmin)
    normr_new = np.sqrt(_read_rows(R, ops.wdot_many(w, r_new, r_new))[0]
                        .astype(f))
    cold = cold_carry_many(xmin, r_new, normr_new, ops.dot_dtype, variant)
    sel = _Masks(fext.device, m=m)
    out = dict(carry)
    for k, v in cold.items():
        if isinstance(v, torch.Tensor):
            out[k] = sel.sel("m", v, carry[k])
        else:
            out[k] = np.where(m, v, np.asarray(carry[k], v.dtype))
    # the cold carry's prec_sel 0 would undo an earlier fallback
    out["prec_sel"] = np.where(np.asarray(fallback_mask, bool), 1,
                               np.asarray(carry["prec_sel"], np.int64))
    out["flag"] = np.where(np.asarray(quarantine_mask, bool),
                           QUARANTINE_FLAG, out["flag"])
    return out


def pcg_mixed_many(
    ops32: Ops,
    data32: dict,
    ops64: Ops,
    data64: dict,
    fext: torch.Tensor,       # (R, P, n_loc) f64 rhs block on eff dofs
    x0: torch.Tensor,         # (R, P, n_loc) f64 initial guesses
    inv_diag32,               # f32 preconditioner operand, shared
    tol: float,
    max_iter: int,
    glob_n_dof_eff: int,
    max_stag_steps: int = 3,
    inner_tol: float = 1e-5,
    max_outer: int = 12,
    variant: str = "classic",
    plateau_window: int = 0,
    progress_window: int = 0,
    progress_ratio: float = 0.7,
    progress_min_gain: float = 30.0,
) -> PCGResult:
    """Blocked ``pcg_mixed``: f32 ``pcg_many`` cycles on each column's
    normalised residual (zeroed for the columns not running this cycle,
    whose inner solve then exits at once), the true residual refreshed by
    ONE blocked f64 matvec a cycle and the solution accumulated in f64.
    Each column's inner budget is its own ``max_iter - total``.  Per
    column: flag 0 at tol, 3 when a cycle failed to halve its residual, 2
    after an inner inf-preconditioner exit, 1 when ``max_outer`` cycles or
    ``max_iter`` inner iterations are spent; ``iters`` the executed inner
    iterations.  ``data32`` and ``data64`` are the trees of
    ``parallel.structured.block_data`` for this width."""
    eff64 = data64["eff"]
    w64 = data64["weight"] * eff64
    f = _np_type(ops64.dot_dtype)
    R = fext.shape[0]
    dev = fext.device

    def amul64(v):
        return eff64 * ops64.matvec(data64, v)

    def norms(t):
        return np.sqrt(_read_rows(R, t)[0].astype(f))

    n2b = norms(ops64.wdot_many(w64, fext, fext))
    tolb = f(tol) * n2b

    x = x0
    normr_prev = np.full(R, np.inf, f)
    outer = np.zeros(R, np.int64)
    total = np.zeros(R, np.int64)
    flag = np.where(n2b == 0, 0, -1)
    fatal2 = np.zeros(R, bool)
    trips = 0
    while (flag == -1).any():
        # the f64 residual of the CURRENT x, refreshed at the top
        r = fext - amul64(x)
        normr = norms(ops64.wdot_many(w64, r, r))
        live = flag == -1
        converged = normr <= tolb
        # refinement must contract the residual (first cycle: never trips)
        stalled = normr > f(0.5) * normr_prev
        exhausted = (outer >= max_outer) | (total >= max_iter)
        run = live & ~(converged | stalled | fatal2 | exhausted)
        inner_flag = np.ones(R, np.int64)
        exec_n = np.zeros(R, np.int64)
        if run.any():
            scale = torch.from_numpy(np.where(run, normr, f(1)))
            if dev.type == "cuda":
                scale = scale.pin_memory().to(dev, non_blocking=True)
            scale = scale[:, None, None]
            sel = _Masks(dev, run=run)
            rhat32 = sel.sel("run", lambda: r / scale,
                             torch.zeros_like(r)).to(torch.float32)
            inner, ic = pcg_many(
                ops32, data32, fext=rhat32, x0=torch.zeros_like(rhat32),
                inv_diag=inv_diag32,
                tol=refine_tol(tolb, normr, inner_tol),
                max_iter=np.maximum(max_iter - total, 1),
                glob_n_dof_eff=glob_n_dof_eff,
                max_stag_steps=max_stag_steps, max_iter_nominal=max_iter,
                return_carry=True, x0_zero=True, variant=variant,
                plateau_window=plateau_window,
                progress_window=progress_window,
                progress_ratio=progress_ratio,
                progress_min_gain=progress_min_gain)
            # return_carry skips the min-residual finalize: a
            # non-converged column takes its tracked min-residual iterate
            # when its recurrence norm is the smaller one
            use_min = (inner.flag != 0) & (ic["normrmin"] < ic["normr_act"])
            pick = _Masks(dev, use_min=use_min, run=run)
            xbest = pick.sel("use_min", ic["xmin"], inner.x)
            x = pick.sel("run", lambda: x + xbest.to(fext.dtype) * scale, x)
            exec_n = np.where(run, np.maximum(ic["exec"], 1), 0)
            inner_flag = np.where(run, inner.flag, 1)
            trips += inner.trips
        flag = np.where(~live, flag,
                        np.where(converged, 0,
                                 np.where(stalled, 3,
                                          np.where(fatal2, 2,
                                                   np.where(exhausted, 1,
                                                            -1)))))
        normr_prev = np.where(live, normr, normr_prev)
        outer = outer + run
        total = total + exec_n
        fatal2 = inner_flag == 2

    zero_rhs = n2b == 0
    with np.errstate(divide="ignore", invalid="ignore"):
        relres = np.where(zero_rhs, 0.0, normr_prev / n2b).astype(np.float32)
    x = _Masks(dev, zero=zero_rhs).sel("zero", lambda: torch.zeros_like(x),
                                       x)
    return PCGResult(x=x, flag=flag, relres=relres, iters=total, trips=trips)
