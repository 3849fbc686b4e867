"""The operator protocol shared by every backend of the PCG stack.

Port of the parts of ``pcg_mpi_solver_tpu/ops/matvec.py::Ops`` the
structured slice needs: the static-shape fields (with ``mg_degree``, the
V-cycle's Chebyshev degree), the owner-weighted dots (``_local_dot`` /
``wdot`` / ``wdots``), the node-row views ``_as_node3`` /
``_from_node3``, ``block_precond`` and ``apply_prec`` (scalar Jacobi,
3x3 block Jacobi, and the mg V-cycle of ``ops/mg.py``).  Vectors are ``(P, n_loc)`` tensors with one row per part;
the parts of one process are all on one device, so the cross-process
reduction (``_psum``) is the identity.  The operator itself (``matvec``,
``diag``) comes from the backend subclass (``parallel/structured.py``).
"""

from __future__ import annotations

import dataclasses

import torch

from pcg_mpi_solver_tpu_torch.ops.mg import mg_apply
from pcg_mpi_solver_tpu_torch.ops.precond import invert_node_blocks


@dataclasses.dataclass(frozen=True)
class Ops:
    """Static-shape metadata + the operator methods."""

    n_loc: int
    n_iface: int
    n_node_loc: int = 0
    n_node_iface: int = 0
    dot_dtype: torch.dtype = torch.float64
    # Chebyshev degree of the mg V-cycle's smoother (precond="mg"), set by
    # Solver from SolverConfig.mg_smooth_degree
    mg_degree: int = 2

    def _psum(self, x: torch.Tensor) -> torch.Tensor:
        """Cross-process sum: the identity while the port runs in one
        process (multi-process sharding is ROADMAP queue 1 item 12)."""
        return x

    def _as_node3(self, v: torch.Tensor) -> torch.Tensor:
        """(P, n_loc) dof vector -> (P, n_node_loc, 3) node rows (the
        node-contiguous layout; StructuredOps overrides it for its
        component-major grid layout)."""
        return v.reshape(v.shape[0], self.n_node_loc, 3)

    def _from_node3(self, z3: torch.Tensor) -> torch.Tensor:
        """Inverse of :meth:`_as_node3`."""
        return z3.reshape(z3.shape[0], self.n_loc)

    def block_precond(self, data: dict) -> torch.Tensor:
        """Inverted eff-masked node blocks (P, n_node_loc, 3, 3), ready
        for ``apply_prec``."""
        return invert_node_blocks(self.node_block_diag(data),
                                  self._as_node3(data["eff"]))

    def apply_prec(self, m, r: torch.Tensor, data: dict = None
                   ) -> torch.Tensor:
        """z = M^-1 r: elementwise for the scalar Jacobi inverse (P,
        n_loc), a 3x3 product per node for the block-Jacobi inverse (P,
        n_node_loc, 3, 3), or one V-cycle when ``m`` is the mg prec dict
        (``data`` is then the device tree the hierarchy rides)."""
        if r.dim() != 2:
            raise NotImplementedError(
                "a trailing right-hand-side axis is not ported yet "
                "(ROADMAP queue 1, blocked right-hand sides: item 7)")
        if isinstance(m, dict):
            return mg_apply(self, data, m, r)
        if m.dim() == 2:
            return m * r
        z3 = (m * self._as_node3(r)[..., None, :]).sum(dim=-1)
        return self._from_node3(z3)

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
