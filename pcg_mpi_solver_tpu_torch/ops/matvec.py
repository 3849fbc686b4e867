"""The operator protocol shared by every backend of the PCG stack.

Port of the parts of ``pcg_mpi_solver_tpu/ops/matvec.py::Ops`` the
structured slice needs: the static-shape fields (with ``mg_degree``, the
V-cycle's Chebyshev degree), the owner-weighted dots (``_local_dot`` /
``wdot`` / ``wdots``) and their per-column twins for a block of
right-hand sides (``wdot_many`` / ``wdots_many``), the node-row views
``_as_node3`` / ``_from_node3``, ``block_precond`` and ``apply_prec``
(scalar Jacobi, 3x3 block Jacobi, and the mg V-cycle of
``ops/mg.py``).  Vectors are ``(P, n_loc)`` tensors with one row per
part; a block of R right-hand sides is ``(R, P, n_loc)``, the column axis
leading (the JAX package carries it trailing, ``(P, n_loc, R)``), so a
column is one contiguous vector.  The parts of one process are all on
one device, so the cross-process reduction (``_psum``) is the identity.
The operator itself (``matvec``, ``diag``) comes from the backend
subclass (``parallel/structured.py``).
"""

from __future__ import annotations

import dataclasses

import torch

from pcg_mpi_solver_tpu_torch.ops.mg import mg_apply
from pcg_mpi_solver_tpu_torch.ops.precond import invert_node_blocks

# row stride (elements) of the per-column dot buffer on the card: 256
# bytes in float32, 512 in float64
_ROW_ALIGN = 64


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
        """([R,] P, n_loc) dof vector -> ([R,] P, n_node_loc, 3) node rows
        (the node-contiguous layout; StructuredOps overrides it for its
        component-major grid layout)."""
        return v.reshape(*v.shape[:-1], self.n_node_loc, 3)

    def _from_node3(self, z3: torch.Tensor) -> torch.Tensor:
        """Inverse of :meth:`_as_node3`."""
        return z3.reshape(*z3.shape[:-2], self.n_loc)

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
        (``data`` is then the device tree the hierarchy rides).  ``r``
        may be a block (R, P, n_loc): the operand broadcasts over its
        leading column axis."""
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

    # -- per-column reductions of a right-hand-side block ----------------
    def _local_dots_many(self, w, pairs) -> torch.Tensor:
        """(len(pairs), R) local weighted dots of blocks (R, P, n_loc),
        cast to the dot dtype before multiplying as :meth:`_local_dot`
        does, in ONE sum over the rows of one buffer of products.  On the
        card its row stride is padded with zeros to a multiple of
        ``_ROW_ALIGN`` elements: a CUDA sum starts its vectorised loads
        where a row's alignment lets it, so rows at other offsets would be
        summed in other orders; padded, every column is summed in the same
        order (a column 2F gives exactly twice F's dots).  The CPU's sum
        does not depend on alignment, and its rows are not padded."""
        dd = self.dot_dtype
        a0 = pairs[0][0]
        R, n = a0.shape[0], a0[0].numel()
        npad = -(-n // _ROW_ALIGN) * _ROW_ALIGN if a0.is_cuda else n
        buf = torch.empty((len(pairs), R, npad), dtype=dd, device=a0.device)
        if npad > n:
            buf[..., n:] = 0
        wd = w.to(dd)
        for i, (a, b) in enumerate(pairs):
            torch.mul(a.to(dd) * b.to(dd), wd,
                      out=buf[i, :, :n].view(a.shape))
        return buf.sum(dim=-1)

    def wdot_many(self, w: torch.Tensor, a: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
        """Per-column global weighted dots <a_j, b_j>_w: (R,)."""
        return self._psum(self._local_dots_many(w, [(a, b)])[0])

    def wdots_many(self, w: torch.Tensor, pairs, extra=()) -> torch.Tensor:
        """Several per-column dots in ONE reduction, optionally carrying
        extra pre-reduced (R,) rows: (k + len(extra), R)."""
        loc = self._local_dots_many(w, pairs)
        if extra:
            loc = torch.cat([loc] + [
                torch.as_tensor(e, dtype=self.dot_dtype,
                                device=w.device)[None] for e in extra])
        return self._psum(loc)
