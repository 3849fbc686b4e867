"""Preconditioner builders.

Port of ``pcg_mpi_solver_tpu/ops/precond.py``: the scalar Jacobi inverse
(the eff-masked inverse of the assembled diagonal), the node-block (3x3)
Jacobi inverse (``invert_node_blocks`` over the blocks a backend assembles
with ``node_block_diag``), the brick-grid block assembly
``corner_block_field`` and the mg prec operand (``ops/mg.py``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from pcg_mpi_solver_tpu_torch.config import PRECONDS


def invert_node_blocks(B: torch.Tensor, eff3: torch.Tensor) -> torch.Tensor:
    """Invert per-node 3x3 blocks restricted to effective (free) dofs.

    B:    (..., n, 3, 3) assembled node-diagonal blocks of K (SPD on the
          free dofs).
    eff3: (..., n, 3) 0/1 mask of effective dofs (0 = Dirichlet-fixed or
          padding).

    Fixed components are decoupled by masking row and column and placing
    1 on the diagonal, so the inverse acts as the identity there.  The
    inversion is by explicit adjugate on blocks normalized by their
    diagonal max, always computed in float64 and cast back to ``B``'s
    dtype (the determinant of an ill-conditioned block is cancellation in
    float32).  A block whose normalized determinant is at or below the
    cutoff (eps32^1.5 for float32 output, eps64 for float64) falls back to
    the scalar-Jacobi inverse of its diagonal; a zero diagonal on an
    effective dof maps to inf, which PCG reports as flag 2, as the scalar
    path's 1/0 does.
    """
    out_dt = B.dtype
    dt = torch.float64
    e = eff3.to(dt)
    eye = torch.eye(3, dtype=dt, device=B.device)
    B = B.to(dt)
    Bm = B * e[..., :, None] * e[..., None, :] \
        + (1.0 - e)[..., :, None] * eye

    # normalize: s ~ the block's diagonal scale (>= 1 on fixed/padded rows)
    d = torch.diagonal(Bm, dim1=-2, dim2=-1)
    s = d.abs().amax(dim=-1)
    s = torch.where(s > 0, s, torch.ones((), dtype=dt, device=B.device))
    a = Bm / s[..., None, None]

    def at(i, j):
        return a[..., i, j]

    c00 = at(1, 1) * at(2, 2) - at(1, 2) * at(2, 1)
    c01 = at(1, 2) * at(2, 0) - at(1, 0) * at(2, 2)
    c02 = at(1, 0) * at(2, 1) - at(1, 1) * at(2, 0)
    det = at(0, 0) * c00 + at(0, 1) * c01 + at(0, 2) * c02

    # adj[i, j] = cofactor(j, i)
    adj = torch.stack([
        torch.stack([c00,
                     at(0, 2) * at(2, 1) - at(0, 1) * at(2, 2),
                     at(0, 1) * at(1, 2) - at(0, 2) * at(1, 1)], dim=-1),
        torch.stack([c01,
                     at(0, 0) * at(2, 2) - at(0, 2) * at(2, 0),
                     at(0, 2) * at(1, 0) - at(0, 0) * at(1, 2)], dim=-1),
        torch.stack([c02,
                     at(0, 1) * at(2, 0) - at(0, 0) * at(2, 1),
                     at(0, 0) * at(1, 1) - at(0, 1) * at(1, 0)], dim=-1),
    ], dim=-2)

    # the determinant of the stored block is exact to ~1e-16 in float64,
    # so the cutoff is a conditioning policy: an ill-conditioned but valid
    # SPD block (det ~1e-7) keeps its block inverse under float32 output
    if out_dt == torch.float32:
        cutoff = float(np.finfo(np.float32).eps) ** 1.5   # ~4e-11
    else:
        cutoff = float(np.finfo(np.float64).eps)
    zero = torch.zeros((), dtype=dt, device=B.device)
    one = torch.ones((), dtype=dt, device=B.device)
    ok = det.abs() > cutoff
    dinv = torch.where(ok, 1.0 / torch.where(ok, det, one), zero)
    inv = adj * (dinv / s)[..., None, None]

    # degenerate block: scalar Jacobi on its diagonal (embedded by select,
    # not multiply: inf * 0 would be NaN)
    dvals = torch.where(d != 0, 1.0 / torch.where(d != 0, d, one),
                        torch.full((), float("inf"), dtype=dt,
                                   device=B.device))
    scalar = torch.where(eye > 0, dvals[..., :, None], zero)
    return torch.where(ok[..., None, None], inv, scalar).to(out_dt)


def fallback_kind(kind: str):
    """The next-weaker-but-safer preconditioner of the JAX package's
    recovery ladder: scalar Jacobi for block3 and mg, None for Jacobi
    (nothing weaker is still a preconditioner).  ``RecoveryLadder``
    (resilience/recovery.py) takes its fallback rung only when this is
    not None."""
    return "jacobi" if kind in ("block3", "mg") else None


def corner_block_field(Ke: torch.Tensor, ck: torch.Tensor,
                       corners) -> torch.Tensor:
    """Brick-grid node-block assembly: every cell adds ``ck * Ke[3a:3a+3,
    3a:3a+3]`` to its corner-``a`` node, as 8 zero-padded 9-channel
    translates summed in corner order.  ck: (P, cx, cy, cz) cell grid ->
    (P, 9, cx+1, cy+1, cz+1) node grid."""
    Ke4 = Ke.reshape(8, 3, 8, 3)
    D9 = torch.stack([Ke4[a, :, a, :].reshape(9) for a in range(8)])
    g = None
    for a, (dx, dy, dz) in enumerate(corners):
        contrib = D9[a][None, :, None, None, None] * ck[:, None]
        t = F.pad(contrib, (dz, 1 - dz, dy, 1 - dy, dx, 1 - dx))
        g = t if g is None else g + t
    return g


def make_prec(ops, data: dict, kind: str):
    """The preconditioner operand for ``kind``, ready for
    ``ops.apply_prec`` inside the PCG loop: the scalar Jacobi inverse
    (P, n_loc), the block-Jacobi inverse (P, n_node_loc, 3, 3), or for
    "mg" the prec dict ``{"mg_diag": scalar Jacobi inverse, "fb": 0}``
    the V-cycle reads (its hierarchy rides ``data["mg"]``).  ``fb`` is
    the demotion switch, a host int: the recovery ladder's
    ``ops/mg.fallback_operand`` sets it, and ``mg_apply`` then applies
    scalar Jacobi."""
    if kind not in PRECONDS:
        raise ValueError(f"precond must be one of {PRECONDS}, got {kind!r}")
    if kind == "block3":
        return ops.block_precond(data)
    diag_k = ops.diag(data)
    inv = torch.where(data["eff"] > 0, 1.0 / diag_k,
                      torch.zeros((), dtype=diag_k.dtype,
                                  device=diag_k.device))
    if kind == "mg":
        return {"mg_diag": inv, "fb": 0}
    return inv
