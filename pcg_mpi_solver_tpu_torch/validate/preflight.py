"""Preflight checks of a blocked right-hand side, of an mg hierarchy and of
an explicit time step.

Port of ``CheckResult``, ``PreflightError``, ``check_rhs_block``, the
construction-time mg checks and the explicit-dt check of
``pcg_mpi_solver_tpu/validate/preflight.py`` (:36-59, :248-287, :290-363,
:386-452): the gate ``Solver.solve_many`` puts in front of a block of load
cases, the gate ``Solver`` puts in front of an mg hierarchy
(:func:`run_mg_preflight`: a lattice that cannot coarsen, or coarsen
``mg_levels`` times, or whose replicated levels exceed
``mg_max_replicated_dofs``, fails before the partition is built), and the
gate of the time-history drivers (:func:`run_time_preflight`: the mg
checks, and for ``DynamicsSolver`` its dt against the CFL bound: a
caller's dt above it fails, a model file's dt above it warns).  A check
returns a :class:`CheckResult` of severity ``fail`` (the input is
unusable: :class:`PreflightError`), ``warn`` (usable but suspicious) or
``ok``.  The policy is ``PCG_TPU_PREFLIGHT`` (fail, warn or off; default
fail), as in the JAX package; its ``RunConfig.preflight`` knob and the
model checks (shapes, finiteness, materials, connectivity) are ROADMAP
queue 1 item 14.
"""

from __future__ import annotations

import dataclasses
import math
import os
import warnings
from typing import Any, List

import numpy as np

POLICIES = ("fail", "warn", "off")


class PreflightError(ValueError):
    """A fail-severity preflight check rejected the input."""


@dataclasses.dataclass
class CheckResult:
    name: str
    status: str            # "ok" | "warn" | "fail"
    detail: str = ""

    def to_event(self) -> dict:
        return {"name": self.name, "status": self.status,
                "detail": self.detail}


def check_rhs_block(fexts: Any, n_dof: int) -> List[CheckResult]:
    """Per-column validation of a blocked right-hand side (n_dof, nrhs):
    the shape contract, a NaN/Inf scan that names the offending column
    indices, all-zero columns (warn) and a load-norm spread above 1e10
    across the block (warn: the small column may stagnate near the
    precision floor of the shared lockstep arithmetic)."""
    a = np.asarray(fexts)
    if a.ndim != 2:
        return [CheckResult(
            "rhs_block_shape", "fail",
            f"fext block must be 2-D (n_dof, nrhs), got shape {a.shape}")]
    if a.shape[0] != n_dof:
        return [CheckResult(
            "rhs_block_shape", "fail",
            f"fext block rows {a.shape[0]} != n_dof {n_dof} "
            f"(columns are load cases)")]
    if a.shape[1] < 1:
        return [CheckResult("rhs_block_shape", "fail",
                            "fext block has zero columns")]
    if a.dtype.kind != "f":
        return [CheckResult(
            "rhs_block_shape", "fail",
            f"fext block dtype {a.dtype} is not floating")]
    results = [CheckResult("rhs_block_shape", "ok")]
    finite_cols = np.isfinite(a).all(axis=0)
    if not finite_cols.all():
        bad = np.flatnonzero(~finite_cols)
        per_col = ", ".join(
            f"rhs {int(j)} ({int(np.count_nonzero(~np.isfinite(a[:, j])))} "
            "non-finite)" for j in bad[:8])
        more = f" (+{bad.size - 8} more)" if bad.size > 8 else ""
        results.append(CheckResult(
            "rhs_block_finite", "fail",
            f"NaN/Inf in column(s): {per_col}{more}"))
    else:
        results.append(CheckResult("rhs_block_finite", "ok"))
    zero_cols = ~np.any(a, axis=0) if a.size else np.zeros(0, bool)
    if zero_cols.any():
        results.append(CheckResult(
            "rhs_block_zero", "warn",
            f"all-zero column(s) {np.flatnonzero(zero_cols).tolist()}: "
            "they solve to x = 0 but still ride every blocked matvec"))
    else:
        results.append(CheckResult("rhs_block_zero", "ok"))
    if finite_cols.all() and not zero_cols.any() and a.shape[1] > 1:
        norms = np.linalg.norm(a, axis=0)
        lo, hi = float(norms.min()), float(norms.max())
        if lo > 0 and hi / lo > 1e10:
            results.append(CheckResult(
                "rhs_block_spread", "warn",
                f"column load norms span {hi / lo:.1e}x (min rhs "
                f"{int(np.argmin(norms))}, max rhs "
                f"{int(np.argmax(norms))}): the small-norm column may "
                "stagnate/quarantine near the precision floor of the "
                "blocked solve — consider solving it separately"))
        else:
            results.append(CheckResult("rhs_block_spread", "ok"))
    return results


def resolve_policy() -> str:
    """The effective policy: ``PCG_TPU_PREFLIGHT``, else fail; a
    malformed value raises rather than disabling the gate."""
    p = os.environ.get("PCG_TPU_PREFLIGHT", "").strip() or "fail"
    if p not in POLICIES:
        raise ValueError(f"preflight policy must be one of {POLICIES}, "
                         f"got {p!r} (PCG_TPU_PREFLIGHT / --preflight)")
    return p


def _check_mg_hierarchy(model, scfg) -> CheckResult:
    """precond='mg' eligibility: a vector problem with a lattice that
    coarsens (``mg_levels`` times when set), the reasons
    ``ops/mg.build_mg_host`` raises."""
    if getattr(scfg, "precond", "jacobi") != "mg":
        return CheckResult("mg_hierarchy", "ok")
    if int(model.n_dof) != 3 * int(model.n_node):
        return CheckResult(
            "mg_hierarchy", "fail",
            "precond='mg' needs the vector (3-dof/node) problem class; "
            f"this model has n_dof={model.n_dof}, n_node={model.n_node}")
    from pcg_mpi_solver_tpu_torch.ops.mg import (
        MGSetupError, fine_lattice, plan_levels)

    dims, _lat = fine_lattice(model)
    if dims is None:
        return CheckResult(
            "mg_hierarchy", "fail",
            "precond='mg' needs lattice metadata (ModelData.grid or "
            ".octree); this model has neither — use precond='jacobi'")
    try:
        plan_levels(dims, int(getattr(scfg, "mg_levels", 0)))
    except MGSetupError as e:
        return CheckResult("mg_hierarchy", "fail", str(e))
    return CheckResult("mg_hierarchy", "ok")


def _check_mg_replication(model, scfg) -> CheckResult:
    """The replicated coarse levels against
    ``SolverConfig.mg_max_replicated_dofs``: fail where
    ``ops/mg.apply_replication_cutoff`` raises, warn where it truncates
    an auto-depth hierarchy."""
    if getattr(scfg, "precond", "jacobi") != "mg":
        return CheckResult("mg_replication", "ok")
    cap = int(getattr(scfg, "mg_max_replicated_dofs", 0))
    if cap <= 0:
        return CheckResult("mg_replication", "ok")
    from pcg_mpi_solver_tpu_torch.ops.mg import (
        MGSetupError, apply_replication_cutoff, fine_lattice,
        level_replicated_dofs, plan_levels)

    dims, _lat = fine_lattice(model)
    if dims is None:
        return CheckResult("mg_replication", "ok")   # mg_hierarchy fails
    n_levels = int(getattr(scfg, "mg_levels", 0))
    try:
        planned = plan_levels(dims, n_levels)
    except MGSetupError:
        return CheckResult("mg_replication", "ok")   # mg_hierarchy fails
    try:
        kept = apply_replication_cutoff(planned, n_levels, cap)
    except MGSetupError as e:
        return CheckResult("mg_replication", "fail", str(e))
    if len(kept) < len(planned):
        total = sum(level_replicated_dofs(planned))
        return CheckResult(
            "mg_replication", "warn",
            f"mg hierarchy will be truncated from {len(planned)} to "
            f"{len(kept)} coarse level(s): the full hierarchy needs "
            f"{total} replicated dofs per device, over the "
            f"mg_max_replicated_dofs={cap} cutoff")
    return CheckResult("mg_replication", "ok")


def _check_explicit_dt(model, context) -> CheckResult:
    """Explicit central-difference stability: dt against the CFL estimate
    (``solver/dynamics.stable_dt`` at safety 1).  The severity follows
    ``dt_source``: a caller's dt (``arg``) above the bound fails, a dt
    from the model file (``model``: legacy bundles carry a 1.0
    placeholder) warns, the CFL default (``cfl``) is the estimate itself
    and passes."""
    ctx = context or {}
    dt = ctx.get("dt")
    src = ctx.get("dt_source", "arg")
    if dt is None or src == "cfl":
        return CheckResult("explicit_dt", "ok")
    if not (math.isfinite(dt) and dt > 0):
        return CheckResult("explicit_dt", "fail",
                           f"explicit dt={dt} must be a finite positive "
                           "number")
    from pcg_mpi_solver_tpu_torch.solver.dynamics import stable_dt

    try:
        bound = stable_dt(model, safety=1.0)
    except (ValueError, ZeroDivisionError, KeyError) as e:
        return CheckResult("explicit_dt", "warn",
                           f"stable_dt estimate unavailable "
                           f"({type(e).__name__}: {e})")
    if not (math.isfinite(bound) and bound > 0):
        return CheckResult("explicit_dt", "warn",
                           f"stable_dt estimate non-finite ({bound})")
    if dt > bound:
        return CheckResult(
            "explicit_dt", "fail" if src == "arg" else "warn",
            f"dt={dt:.3e} ({src}) exceeds the CFL stability estimate "
            f"{bound:.3e}: the integration diverges within a few steps")
    if dt > 0.95 * bound:
        return CheckResult(
            "explicit_dt", "warn",
            f"dt={dt:.3e} is within 5% of the CFL estimate {bound:.3e} "
            "(the estimate is conservative for hexes but not exact)")
    return CheckResult("explicit_dt", "ok")


def _enforce(results: List[CheckResult], pol: str, recorder=None,
             kind: str = "") -> List[CheckResult]:
    """Apply the policy to ``results``: under ``fail`` a failed check
    raises :class:`PreflightError` with the JAX package's message, under
    ``warn`` it warns.  With a recorder, one ``preflight`` event carries
    every check (warn-severity findings are reported there only, as in
    the JAX package)."""
    failed = [r for r in results if r.status == "fail"]
    if recorder is not None:
        recorder.event("preflight", policy=pol, context=kind,
                       failed=len(failed),
                       warned=sum(r.status == "warn" for r in results),
                       checks=[r.to_event() for r in results])
    if failed:
        msg = "preflight rejected the model/config: " + "; ".join(
            f"[{r.name}] {r.detail}" for r in failed) + \
            "  (set PCG_TPU_PREFLIGHT=warn/off or --preflight= to bypass)"
        if pol == "fail":
            raise PreflightError(msg)
        warnings.warn(msg, stacklevel=4)
    return results


def _mg_checks(model, config) -> List[CheckResult]:
    scfg = config.solver
    return [_check_mg_hierarchy(model, scfg),
            _check_mg_replication(model, scfg)]


def run_mg_preflight(model, config) -> List[CheckResult]:
    """The mg checks under the preflight policy (:func:`resolve_policy`);
    ``off`` scans nothing."""
    pol = resolve_policy()
    if pol == "off":
        return []
    return _enforce(_mg_checks(model, config), pol)


def run_time_preflight(model, config, context: dict,
                       recorder=None) -> List[CheckResult]:
    """The time-history drivers' gate under the preflight policy: the mg
    checks and, for ``context["kind"] == "dynamics"``, the explicit dt
    (``context["dt"]``, ``context["dt_source"]``) against the CFL bound.
    The model checks (shapes, finiteness, materials, connectivity) are
    ROADMAP queue 1 item 14."""
    pol = resolve_policy()
    if pol == "off":
        return []
    results = _mg_checks(model, config)
    if context.get("kind") == "dynamics":
        results.append(_check_explicit_dt(model, context))
    return _enforce(results, pol, recorder, context.get("kind", ""))
