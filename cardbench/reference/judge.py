"""The judge of one load case: the relative residual of the program's
displacement field, by the reference operator, against the configuration's
tolerance.

For a load f and prescribed displacements u_d (delta * Ud for a step, 0
for a block column, whose Dirichlet data is homogeneous), a displacement
field u solves the case to tolerance tol when

    || (f - K u)[eff] || / || (f - K u_d)[eff] || <= tol

over the effective (free) dofs, and u equals u_d on the fixed dofs.  The
solver stops on the same quantity, computed by its own operator in float64
(the reference solver's true-residual check, pcg_solver.py:527-533), so a
sound solve reads at most tol here; the configuration states tol, and that
is the limit.  A displacement that is off on the fixed dofs reads as
infinitely wrong.
"""

from __future__ import annotations

import math

import numpy as np
import torch


class Judge:
    """relres(u, f, ud) for one model, on ``device``."""

    def __init__(self, model, operator):
        self.K = operator
        dev = operator.device
        self.eff = torch.zeros(int(model.n_dof), dtype=torch.bool,
                               device=dev)
        self.eff[torch.as_tensor(np.asarray(model.dof_eff, np.int64),
                                 device=dev)] = True
        self.fixed = torch.as_tensor(np.asarray(model.fixed_dof, np.int64),
                                     device=dev)

    def _t(self, v):
        return torch.as_tensor(np.asarray(v, dtype=np.float64),
                               device=self.K.device)

    def relres(self, u, f, ud=None) -> float:
        """The relative residual of u; inf where u leaves the fixed dofs'
        prescribed values, nan where u is not finite."""
        u, f = self._t(u), self._t(f)
        ud = torch.zeros_like(u) if ud is None else self._t(ud)
        if not bool(torch.isfinite(u).all()):
            return math.nan
        if not bool(torch.equal(u[self.fixed], ud[self.fixed])):
            return math.inf
        r = (f - self.K(u))[self.eff]
        b = (f - self.K(ud))[self.eff] if bool(ud.any()) else f[self.eff]
        nb = float(torch.linalg.vector_norm(b))
        return float(torch.linalg.vector_norm(r)) / nb if nb else math.inf
