"""Preconditioner builders.

Port of ``pcg_mpi_solver_tpu/ops/precond.py::make_prec`` for the scalar
Jacobi preconditioner: the eff-masked inverse of the assembled diagonal.
"""

from __future__ import annotations

import torch

from pcg_mpi_solver_tpu_torch.config import PRECONDS


def make_prec(ops, data: dict, kind: str) -> torch.Tensor:
    """The preconditioner inverse for ``kind``, ready for
    ``ops.apply_prec`` inside the PCG loop."""
    if kind not in PRECONDS:
        raise ValueError(f"precond must be one of {PRECONDS}, got {kind!r}")
    if kind != "jacobi":
        raise NotImplementedError(
            f"precond {kind!r} is not ported yet (block3: ROADMAP queue 1 "
            f"item 4; mg: item 5)")
    diag_k = ops.diag(data)
    return torch.where(data["eff"] > 0, 1.0 / diag_k,
                       torch.zeros((), dtype=diag_k.dtype,
                                   device=diag_k.device))
