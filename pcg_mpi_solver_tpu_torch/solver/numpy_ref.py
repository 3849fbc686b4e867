"""Single-process numpy reference backend.

Port of ``pcg_mpi_solver_tpu/solver/numpy_ref.py``.  Serves two purposes:

1. Parity oracle: the same matrix-free type-grouped math as the card
   path, in plain float64 numpy, structured like the reference's per-rank
   compute (gather -> sign -> Ke @ (ck*u) -> bincount scatter,
   pcg_solver.py:277-300) but without MPI — a stand-in for the "1-rank
   mpi4py" reference.
2. Benchmark baseline: per-iteration cost of the CPU implementation the
   reference would run on the machine the bench runs on (``bench.py``'s
   live baseline).

Independent implementation (numpy only; importing it loads no torch): do
not "fix" it to match the card path; disagreements between the two are
signal.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from pcg_mpi_solver_tpu_torch.models.model_data import ModelData
from pcg_mpi_solver_tpu_torch.parallel.partition import _csr_take


@dataclasses.dataclass
class NumpyRefResult:
    u: np.ndarray
    flag: int
    relres: float
    iters: int
    wall_s: float
    # per-iteration residual norms (oldest -> newest) — the host-side
    # oracle for the card path's convergence ring (obs/trace.py)
    normr_hist: Optional[np.ndarray] = None


class NumpyRefSolver:
    """Matrix-free Jacobi-PCG on the global (unpartitioned) model."""

    def __init__(self, model: ModelData):
        self.model = model
        m = model
        self.groups = []
        for t in sorted(m.elem_lib.keys()):
            e = np.where(m.elem_type == t)[0]
            if len(e) == 0:
                continue
            lib = m.elem_lib[t]
            d = lib["Ke"].shape[0]
            dofs = _csr_take(m.elem_dofs_flat, m.elem_dofs_offset, e).reshape(-1, d).T
            signs = _csr_take(m.elem_sign_flat, m.elem_dofs_offset, e).reshape(-1, d).T
            self.groups.append({
                "Ke": np.asarray(lib["Ke"], float),
                "diagKe": np.asarray(lib["diagKe"], float),
                "dofs": dofs,
                "dofs_flat": dofs.ravel(),
                "signs": signs,
                "ck": np.asarray(m.ck[e], float),
            })
        self.n_dof = m.n_dof
        self.eff = m.dof_eff
        self.springs = m.interface_springs()[:3]   # (dof_a, dof_b, k)

    def matvec(self, x: np.ndarray) -> np.ndarray:
        y = np.zeros(self.n_dof)
        for g in self.groups:
            u = x[g["dofs"]]
            u[g["signs"]] *= -1.0
            v = g["Ke"] @ (g["ck"] * u)
            v[g["signs"]] *= -1.0
            y += np.bincount(g["dofs_flat"], weights=v.ravel(), minlength=self.n_dof)
        sa, sb, sk = self.springs
        if len(sa):
            f = sk * (x[sa] - x[sb])
            np.add.at(y, sa, f)
            np.add.at(y, sb, -f)
        return y

    def diag(self) -> np.ndarray:
        y = np.zeros(self.n_dof)
        for g in self.groups:
            v = g["diagKe"][:, None] * g["ck"][None, :]
            y += np.bincount(g["dofs_flat"], weights=v.ravel(), minlength=self.n_dof)
        sa, sb, sk = self.springs
        if len(sa):
            np.add.at(y, sa, sk)
            np.add.at(y, sb, sk)
        return y

    def solve(self, delta: float = 1.0, tol: float = 1e-7, max_iter: int = 10000,
              x0: Optional[np.ndarray] = None) -> NumpyRefResult:
        """Quasi-static step: Dirichlet lifting + Jacobi-PCG on eff dofs."""
        m = self.model
        t0 = time.perf_counter()
        udi = m.Ud * delta
        fext = (m.F * delta - self.matvec(udi))[self.eff]
        inv_diag = 1.0 / self.diag()[self.eff]

        n2b = np.linalg.norm(fext)
        if n2b == 0:
            return NumpyRefResult(udi, 0, 0.0, 0, time.perf_counter() - t0,
                                  normr_hist=np.zeros(0))
        tolb = tol * n2b

        x = np.zeros(len(self.eff)) if x0 is None else x0[self.eff].copy()
        xg = np.zeros(self.n_dof)

        def amul(v):
            xg[:] = 0.0
            xg[self.eff] = v
            return self.matvec(xg)[self.eff]

        r = fext - amul(x)
        normr = np.linalg.norm(r)
        flag, rho, iters = 1, 1.0, 0
        if normr <= tolb:
            flag, iters = 0, 0
        hist = []
        for i in range(max_iter):
            if flag != 1:
                break
            z = inv_diag * r
            rho_new = float(z @ r)
            if rho_new == 0 or np.isinf(rho_new):
                flag = 4
                break
            p = z if i == 0 else z + (rho_new / rho) * p
            rho = rho_new
            q = amul(p)
            pq = float(p @ q)
            if pq <= 0 or np.isinf(pq):
                flag = 4
                break
            alpha = rho / pq
            x += alpha * p
            r -= alpha * q
            normr = np.linalg.norm(r)
            iters = i + 1
            if normr <= tolb:
                # true-residual confirmation (reference pcg_solver.py:527-533)
                r = fext - amul(x)
                normr = np.linalg.norm(r)
                if normr <= tolb:
                    flag = 0
            hist.append(normr)
            if flag == 0:
                break
        u = udi.copy()
        u[self.eff] += x
        return NumpyRefResult(u, flag, normr / n2b, iters,
                              time.perf_counter() - t0,
                              normr_hist=np.asarray(hist))

    def time_per_iter(self, n_iters: int = 30, delta: float = 1.0) -> float:
        """Measured seconds per PCG iteration (matvec + vector ops)."""
        m = self.model
        udi = m.Ud * delta
        fext = (m.F * delta - self.matvec(udi))[self.eff]
        inv_diag = 1.0 / self.diag()[self.eff]
        x = np.zeros(len(self.eff))
        xg = np.zeros(self.n_dof)

        def amul(v):
            xg[:] = 0.0
            xg[self.eff] = v
            return self.matvec(xg)[self.eff]

        r = fext - amul(x)
        rho = 1.0
        p = None
        t0 = time.perf_counter()
        for i in range(n_iters):
            z = inv_diag * r
            rho_new = float(z @ r)
            p = z if i == 0 else z + (rho_new / rho) * p
            rho = rho_new
            q = amul(p)
            alpha = rho / float(p @ q)
            x += alpha * p
            r -= alpha * q
            np.linalg.norm(r)
        return (time.perf_counter() - t0) / n_iters
