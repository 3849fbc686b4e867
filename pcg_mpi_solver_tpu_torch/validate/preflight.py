"""Preflight checks of a blocked right-hand side.

Port of ``CheckResult``, ``PreflightError`` and ``check_rhs_block`` of
``pcg_mpi_solver_tpu/validate/preflight.py`` (:36-48, :386-452): the gate
``Solver.solve_many`` puts in front of a block of load cases.  A check
returns a :class:`CheckResult` of severity ``fail`` (the block is
unusable: the solve raises :class:`PreflightError`), ``warn`` (usable but
suspicious) or ``ok``.  The model preflight of the JAX package (its other
checks and the policy knob) is not ported (ROADMAP queue 1 item 14).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List

import numpy as np


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
