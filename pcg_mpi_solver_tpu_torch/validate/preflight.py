"""Preflight checks: ModelData sanity + config cross-checks.

Port of ``pcg_mpi_solver_tpu/validate/preflight.py``.  Each check returns
a :class:`CheckResult` with a severity the policy acts on:

* ``fail`` — the input is unusable (NaN loads, zero-volume elements, a
  fully-unconstrained rigid-body system, a broken connectivity table):
  under the default ``fail`` policy construction raises
  :class:`PreflightError` before any partition is built.
* ``warn`` — the input is usable but suspicious (a tolerance below the
  precision mode's attainable floor, a snapshot cadence that never
  fires): recorded in the ``preflight`` telemetry event, never raised.
* ``ok`` — the check passed.

Policy (:func:`resolve_policy`): explicit argument > the caller's
``RunConfig.preflight`` > ``PCG_TPU_PREFLIGHT`` > ``"fail"``.  ``off``
skips the scans entirely.  ``Solver`` runs the gate before its partition
(:func:`run_preflight`), ``NewmarkSolver`` and ``DynamicsSolver`` before
theirs with their context (the explicit dt against the CFL bound);
``Solver.solve_many`` gates each block with :func:`check_rhs_block`.

Every check is O(model size) numpy on the host.
"""

from __future__ import annotations

import dataclasses
import math
import os
import warnings
from typing import Any, Dict, List, Optional

import numpy as np

POLICIES = ("fail", "warn", "off")


class PreflightError(ValueError):
    """A fail-severity preflight check rejected the model/config."""


@dataclasses.dataclass
class CheckResult:
    name: str
    status: str            # "ok" | "warn" | "fail"
    detail: str = ""

    def to_event(self) -> dict:
        return {"name": self.name, "status": self.status,
                "detail": self.detail}


def resolve_policy(policy: Optional[str] = None) -> str:
    """The effective policy: argument > ``PCG_TPU_PREFLIGHT`` > fail.
    A malformed value must not silently disable the gate it configures."""
    p = (policy or "").strip() or \
        os.environ.get("PCG_TPU_PREFLIGHT", "").strip() or "fail"
    if p not in POLICIES:
        raise ValueError(f"preflight policy must be one of {POLICIES}, "
                         f"got {p!r} (PCG_TPU_PREFLIGHT / --preflight)")
    return p


# ----------------------------------------------------------------------
# Individual checks (each returns one CheckResult)
# ----------------------------------------------------------------------

def _finite(name: str, arrs: Dict[str, np.ndarray]) -> CheckResult:
    bad = []
    for label, a in arrs.items():
        a = np.asarray(a)
        if a.size and not np.isfinite(a).all():
            n = int(np.count_nonzero(~np.isfinite(a)))
            bad.append(f"{label} ({n} non-finite)")
    if bad:
        return CheckResult(name, "fail", "NaN/Inf in " + ", ".join(bad))
    return CheckResult(name, "ok")


def _check_shapes(model) -> CheckResult:
    n_dof, n_node, n_elem = model.n_dof, model.n_node, model.n_elem
    probs = []
    for label in ("F", "Ud", "Vd", "diag_M"):
        a = np.asarray(getattr(model, label))
        if a.shape != (n_dof,):
            probs.append(f"{label}.shape={a.shape} != ({n_dof},)")
        elif a.dtype.kind != "f":
            probs.append(f"{label}.dtype={a.dtype} is not floating")
    coords = np.asarray(model.node_coords)
    if coords.shape != (n_node, 3):
        probs.append(f"node_coords.shape={coords.shape} != ({n_node}, 3)")
    for label in ("elem_type", "ck", "cm", "ce", "level", "poly_mat"):
        a = np.asarray(getattr(model, label))
        if a.shape[:1] != (n_elem,):
            probs.append(f"{label}.shape={a.shape} != ({n_elem}, ...)")
    for label in ("fixed_dof", "dof_eff", "elem_dofs_flat"):
        if np.asarray(getattr(model, label)).dtype.kind not in "iu":
            probs.append(f"{label} is not integer-typed")
    if probs:
        return CheckResult("shapes_dtypes", "fail", "; ".join(probs))
    return CheckResult("shapes_dtypes", "ok")


def _check_connectivity(model) -> CheckResult:
    probs = []
    for flat_l, off_l in (("elem_dofs_flat", "elem_dofs_offset"),
                          ("elem_nodes_flat", "elem_nodes_offset")):
        flat = np.asarray(getattr(model, flat_l))
        off = np.asarray(getattr(model, off_l))
        if off.shape != (model.n_elem + 1,):
            probs.append(f"{off_l}.shape={off.shape} != "
                         f"({model.n_elem + 1},)")
            continue
        if off.size and (np.any(np.diff(off) < 0) or off[0] != 0
                         or off[-1] != flat.size):
            probs.append(f"{off_l} is not a monotone 0..len({flat_l}) "
                         "offset table")
    dofs = np.asarray(model.elem_dofs_flat)
    if dofs.size and (dofs.min() < 0 or dofs.max() >= model.n_dof):
        probs.append(f"elem_dofs_flat ids outside [0, {model.n_dof})")
    nodes = np.asarray(model.elem_nodes_flat)
    if nodes.size and (nodes.min() < 0 or nodes.max() >= model.n_node):
        probs.append(f"elem_nodes_flat ids outside [0, {model.n_node})")
    types = np.asarray(model.elem_type)
    known = set(int(t) for t in model.elem_lib)
    if types.size and not set(np.unique(types).tolist()) <= known:
        probs.append("elem_type references types missing from elem_lib")
    if probs:
        return CheckResult("connectivity", "fail", "; ".join(probs))
    return CheckResult("connectivity", "ok")


def _check_elements(model) -> CheckResult:
    level = np.asarray(model.level, dtype=float)
    ce = np.asarray(model.ce, dtype=float)
    ck = np.asarray(model.ck, dtype=float)
    n_degen = int(np.count_nonzero((level <= 0) | (ce <= 0)))
    if n_degen:
        return CheckResult(
            "element_volume", "fail",
            f"{n_degen} zero/negative-volume element(s) "
            "(level/ce <= 0)")
    n_neg = int(np.count_nonzero(ck < 0))
    if n_neg:
        return CheckResult("element_volume", "fail",
                           f"{n_neg} element(s) with negative stiffness "
                           "scale ck")
    n_zero = int(np.count_nonzero(ck == 0))
    if n_zero:
        return CheckResult("element_volume", "warn",
                           f"{n_zero} element(s) with zero stiffness "
                           "scale ck (contribute nothing to K)")
    return CheckResult("element_volume", "ok")


def _check_constraints(model) -> CheckResult:
    fixed = np.asarray(model.fixed_dof)
    if fixed.size == 0:
        return CheckResult(
            "constraints", "fail",
            "no Dirichlet-constrained dofs: the system is a fully-"
            "unconstrained rigid body (K is singular; PCG on it "
            "diverges or converges to an arbitrary translation)")
    if fixed.min() < 0 or fixed.max() >= model.n_dof:
        return CheckResult("constraints", "fail",
                           f"fixed_dof ids outside [0, {model.n_dof})")
    return CheckResult("constraints", "ok")


def _check_dof_partition(model) -> CheckResult:
    fixed = np.asarray(model.fixed_dof)
    eff = np.asarray(model.dof_eff)
    n = int(model.n_dof)
    if not all(a.size == 0 or (a.min() >= 0 and a.max() < n)
               for a in (fixed, eff)):
        return CheckResult("dof_partition", "fail",
                           f"fixed_dof or dof_eff ids outside [0, {n})")
    # two masks instead of the JAX package's intersect1d/union1d sorts of
    # 10M-dof id lists: the same answers for ids in range
    in_f = np.zeros(n, bool)
    in_e = np.zeros(n, bool)
    in_f[fixed] = True
    in_e[eff] = True
    overlap = bool((in_f & in_e).any())
    union = int(np.count_nonzero(in_f | in_e))
    if overlap:
        return CheckResult("dof_partition", "fail",
                           "fixed_dof and dof_eff overlap")
    if fixed.size + eff.size != n or union != n:
        return CheckResult(
            "dof_partition", "fail",
            f"fixed_dof ({fixed.size}) + dof_eff ({eff.size}) do not "
            f"partition the {model.n_dof} dofs")
    return CheckResult("dof_partition", "ok")


def _check_materials(model) -> CheckResult:
    probs = []
    for i, m in enumerate(model.mat_prop or []):
        for key in ("E", "Pos", "Rho"):
            if key in m:
                v = float(m[key])
                if not math.isfinite(v):
                    probs.append(f"mat_prop[{i}].{key} non-finite")
        if "E" in m and float(m["E"]) <= 0:
            probs.append(f"mat_prop[{i}].E <= 0")
        if "Rho" in m and float(m["Rho"]) < 0:
            probs.append(f"mat_prop[{i}].Rho < 0")
    if probs:
        return CheckResult("materials", "fail", "; ".join(probs))
    return CheckResult("materials", "ok")


def _check_solver_params(scfg) -> CheckResult:
    probs = []
    if not (math.isfinite(scfg.tol) and scfg.tol > 0):
        probs.append(f"tol={scfg.tol} must be a finite positive number")
    if scfg.max_iter < 1:
        probs.append(f"max_iter={scfg.max_iter} must be >= 1")
    if int(getattr(scfg, "nrhs", 1)) < 1:
        probs.append(f"nrhs={scfg.nrhs} must be >= 1")
    if probs:
        return CheckResult("solver_params", "fail", "; ".join(probs))
    return CheckResult("solver_params", "ok")


def _check_tol_floor(scfg) -> CheckResult:
    """Mixed-precision / f32 tolerance floor: a tol the precision mode
    cannot reach grinds the full iteration budget every step."""
    if scfg.precision_mode == "mixed" and scfg.tol < 1e-13:
        return CheckResult(
            "tol_floor", "warn",
            f"tol={scfg.tol:.1e} is below the mixed-precision refinement "
            "floor (~1e-13 relative); the solve will burn max_iter "
            "without converging")
    if scfg.precision_mode == "direct" and \
            str(scfg.dtype) == "float32" and scfg.tol < 1e-6:
        return CheckResult(
            "tol_floor", "warn",
            f"tol={scfg.tol:.1e} with direct float32 storage is below "
            "the f32 residual floor (~1e-6 relative)")
    return CheckResult("tol_floor", "ok")


def _check_snapshot_cadence(config, context) -> CheckResult:
    """``n_steps`` is only meaningful on paths where snapshot_every
    counts TIMESTEPS (dynamics/Newmark); the quasi-static driver counts
    chunk boundaries and must not put n_steps in its context."""
    every = int(getattr(config, "snapshot_every", 0))
    if every < 0:
        return CheckResult("snapshot_cadence", "fail",
                           f"snapshot_every={every} must be >= 0")
    n_steps = (context or {}).get("n_steps")
    if every > 0 and n_steps is not None and every > int(n_steps):
        return CheckResult(
            "snapshot_cadence", "warn",
            f"snapshot_every={every} exceeds the {n_steps}-step "
            "schedule: no snapshot will ever be written")
    return CheckResult("snapshot_cadence", "ok")


def _check_explicit_dt(model, context) -> CheckResult:
    """Explicit central-difference stability: dt against the CFL
    estimate (solver/dynamics.stable_dt with safety=1).  Severity keys
    off ``dt_source``: an EXPLICIT caller dt above the bound is a
    fail-class config error; a dt inherited from a model file is only
    warned about (legacy MDF bundles carry dt=1.0 placeholders); the
    CFL default is the estimate itself and always passes."""
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
        severity = "fail" if src == "arg" else "warn"
        return CheckResult(
            "explicit_dt", severity,
            f"dt={dt:.3e} ({src}) exceeds the CFL stability estimate "
            f"{bound:.3e}: the integration diverges within a few steps")
    if dt > 0.95 * bound:
        return CheckResult(
            "explicit_dt", "warn",
            f"dt={dt:.3e} is within 5% of the CFL estimate "
            f"{bound:.3e} (the estimate is conservative for hexes but "
            "not exact)")
    return CheckResult("explicit_dt", "ok")


def _check_mg_hierarchy(model, scfg) -> CheckResult:
    """precond='mg' eligibility: the model must expose a
    coarsenable cell lattice BEFORE the partition build is paid — a non-power-of-two structured lattice, a scalar
    (Poisson-class) model, or a model with no lattice metadata at all
    would otherwise die mid-setup with a shape error.  Mirrors the named
    reasons ``ops/mg.build_mg_host`` raises."""
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
    """MG replication scale audit: every coarse level is
    REPLICATED on every device (the zero-collective coarse cycle), so the planned hierarchy's replicated dof total must fit
    the ``SolverConfig.mg_max_replicated_dofs`` cutoff.  Mirrors the
    named reasons ``ops/mg.apply_replication_cutoff`` raises — here the
    arithmetic runs BEFORE any partition build, and a hierarchy the
    cutoff will silently TRUNCATE (auto depth) warns so the shallower-
    than-expected cycle is no surprise."""
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


def check_mg_interval(lmin: float, lmax: float) -> CheckResult:
    """The mg smoother's degenerate Chebyshev interval: the setup's
    estimates [lambda_min, lambda_max] of the coarsest level's D^-1 A.  A
    ratio under 1.05 means the level operator is numerically a multiple
    of its diagonal, so the coarse correction adds nothing (the hierarchy
    coarsened into triviality, or the estimates failed).  Warn, never
    fail: the V-cycle stays a valid, weak, SPD preconditioner."""
    if not (math.isfinite(lmax) and lmax > 0):
        return CheckResult(
            "mg_cheb_interval", "warn",
            f"estimated lambda_max={lmax!r} is not a positive finite "
            "number; the Chebyshev smoother interval is meaningless")
    lo = max(float(lmin), 0.0)
    if lo > 0 and lmax / lo < 1.05:
        return CheckResult(
            "mg_cheb_interval", "warn",
            f"estimated Chebyshev interval is degenerate "
            f"(lambda_max/lambda_min = {lmax / lo:.4f} < 1.05): the "
            "level operator is numerically a multiple of its diagonal "
            "— the mg coarse correction adds ~nothing over Jacobi")
    return CheckResult("mg_cheb_interval", "ok")


def check_rhs_block(fexts: Any, n_dof: int) -> List[CheckResult]:
    """Per-column validation of a blocked right-hand side (the
    ``Solver.solve_many`` request gate): shape contract per RHS and a
    NaN/Inf scan that names the OFFENDING COLUMN INDEX — a multi-tenant
    block must reject the one bad load case comprehensibly, not report
    a whole-array failure.

    ``fexts``: (n_dof, nrhs) array (one column per load case)."""
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
    # norm spread across the block: per-column tolerances are RELATIVE
    # (tolb_j = tol * ||b_j||), so a column whose load norm is many
    # orders below its block-mates chases an absolute residual near the
    # working-precision floor of the SHARED lockstep arithmetic — the
    # classic way one tenant column ends flag 3 (stagnation) or enters
    # the recovery ladder while the rest of the block converges.  Warn,
    # don't fail: the solve is still well-defined.
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


# ----------------------------------------------------------------------
# Runner
# ----------------------------------------------------------------------

def preflight_checks(model, config=None,
                     context: Optional[Dict[str, Any]] = None) \
        -> List[CheckResult]:
    """Run every applicable check; returns all results (never raises)."""
    results = [
        _check_shapes(model),
        _finite("finite_coords", {"node_coords": model.node_coords}),
        _finite("finite_loads", {"F": model.F, "Ud": model.Ud,
                                 "Vd": model.Vd}),
        _finite("finite_mass", {"diag_M": model.diag_M}),
        _finite("finite_scales", {"ck": model.ck, "cm": model.cm,
                                  "ce": model.ce, "level": model.level}),
        _check_materials(model),
        _check_elements(model),
        _check_constraints(model),
        _check_dof_partition(model),
        _check_connectivity(model),
    ]
    if config is not None:
        scfg = config.solver
        results.append(_check_solver_params(scfg))
        results.append(_check_tol_floor(scfg))
        results.append(_check_snapshot_cadence(config, context))
        results.append(_check_mg_hierarchy(model, scfg))
        results.append(_check_mg_replication(model, scfg))
    if (context or {}).get("kind") == "dynamics":
        results.append(_check_explicit_dt(model, context))
    return results


def run_preflight(model, config=None, *, policy: Optional[str] = None,
                  recorder=None,
                  context: Optional[Dict[str, Any]] = None) \
        -> List[CheckResult]:
    """Run the preflight gate: scan, emit ONE ``preflight`` telemetry
    event, and enforce the policy on fail-severity findings.

    Returns the check results (empty under ``off`` — nothing was
    scanned).  Raises :class:`PreflightError` under ``fail`` when any
    check failed; under ``warn`` the same findings become a
    ``warnings.warn`` and construction proceeds at the caller's risk.
    """
    pol = resolve_policy(policy if policy is not None
                         else getattr(config, "preflight", None))
    if pol == "off":
        return []
    results = preflight_checks(model, config, context)
    failed = [r for r in results if r.status == "fail"]
    warned = [r for r in results if r.status == "warn"]
    if recorder is not None:
        recorder.event("preflight", policy=pol,
                       context=(context or {}).get("kind", ""),
                       failed=len(failed), warned=len(warned),
                       checks=[r.to_event() for r in results])
        recorder.inc("preflight.runs")
        if failed:
            recorder.inc("preflight.failed")
    if failed:
        msg = "preflight rejected the model/config: " + "; ".join(
            f"[{r.name}] {r.detail}" for r in failed) + \
            "  (set PCG_TPU_PREFLIGHT=warn/off or --preflight= to bypass)"
        if pol == "fail":
            raise PreflightError(msg)
        warnings.warn(msg, stacklevel=3)
    return results
