"""The operator protocol shared by every backend of the PCG stack.

Port of the parts of ``pcg_mpi_solver_tpu/ops/matvec.py::Ops`` the
structured slice needs: the static-shape fields, the owner-weighted dots
(``_local_dot`` / ``wdot`` / ``wdots``) and the scalar-Jacobi branch of
``apply_prec``.  Vectors are ``(P, n_loc)`` tensors with one row per part;
the parts of one process are all on one device, so the cross-process
reduction (``_psum``) is the identity.  The operator itself (``matvec``,
``diag``) comes from the backend subclass (``parallel/structured.py``).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Ops:
    """Static-shape metadata + the operator methods."""

    n_loc: int
    n_iface: int
    n_node_loc: int = 0
    n_node_iface: int = 0
    dot_dtype: torch.dtype = torch.float64

    def _psum(self, x: torch.Tensor) -> torch.Tensor:
        """Cross-process sum: the identity while the port runs in one
        process (multi-process sharding is ROADMAP queue 1 item 12)."""
        return x

    def apply_prec(self, m: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
        """z = M^-1 r for the scalar Jacobi inverse (P, n_loc)."""
        if not isinstance(m, torch.Tensor) or m.dim() != 2 or r.dim() != 2:
            raise NotImplementedError(
                "only the scalar Jacobi preconditioner on one right-hand "
                "side is ported (block3: ROADMAP queue 1 item 4; mg: item 5; "
                "blocked right-hand sides: item 7)")
        return m * r

    # -- reductions -----------------------------------------------------
    def _local_dot(self, w, a, b) -> torch.Tensor:
        # Cast operands BEFORE multiplying: products of two f32 values are
        # exact in f64, so f32-storage runs get true f64-accumulated dots.
        dd = self.dot_dtype
        return torch.sum(a.to(dd) * b.to(dd) * w.to(dd))

    def wdot(self, w: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor) -> torch.Tensor:
        """Global weighted dot <a, b>_w: dofs duplicated across parts
        counted once via the 0/1 owner weights."""
        return self._psum(self._local_dot(w, a, b))

    def wdots(self, w: torch.Tensor, pairs, extra=()) -> torch.Tensor:
        """Several dots in one reduction, optionally carrying extra
        pre-reduced local scalars in the same vector."""
        loc = torch.stack([self._local_dot(w, a, b) for a, b in pairs]
                          + [torch.as_tensor(e, dtype=self.dot_dtype,
                                             device=w.device)
                             for e in extra])
        return self._psum(loc)
