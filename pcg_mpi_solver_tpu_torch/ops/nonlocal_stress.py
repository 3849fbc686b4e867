"""Nonlocal stress subsystem: Gaussian element neighborhoods + smoothing.

Re-designs the reference's ``config_NonlocalNeighbours``
(partition_mesh.py:1000-1299), which builds — per mesh partition, via
Isend/Recv element-id exchanges and per-element python loops — a sparse
row-normalized weight matrix the dynamics/damage-era solver used to smooth
element stresses over a material length scale.  (The quasi-static reference
solver never consumes it; here the chain is wired end-to-end as the ``NS``
export variable.)

Semantics reproduced exactly (partition_mesh.py:1016-1204):

- cutoff window: a BOX of half-width ``RefLc = Ko * max_i Lc_i`` (Ko = 3.2)
  around each element centroid (Chebyshev metric, not a Euclidean ball);
- same-material filter: only neighbors with the element's own ``PolyMat``;
- weights ``w = exp(-r^2 / (2 Lc^2)) * cellVol`` with Euclidean r,
  ``Lc`` the element's own material length, ``cellVol = level^3``;
- row-normalized (``/= sum`` — removes the boundary effect, :1197).

The neighbor search is one global cKDTree query per material (no p2p
exchanges, no per-element loops), the operator is a global scipy CSR for
host-side (export-path) application plus a padded gather-multiply form
applied on the card (:func:`apply_padded`).  The JAX package's module
(``pcg_mpi_solver_tpu/ops/nonlocal_stress.py``) with the device apply in
torch ops.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from pcg_mpi_solver_tpu_torch.models.model_data import ModelData

KO_DEFAULT = 3.2   # cutoff multiple of Lc (partition_mesh.py:1017)


def material_lc(model: ModelData, default_factor: float = 2.0) -> np.ndarray:
    """Per-material nonlocal length Lc (MatProp NonLocStressParam, read at
    partition_mesh.py:515-520).  Materials without the parameter default to
    ``default_factor * median(level)``."""
    fallback = default_factor * float(np.median(model.level))
    return np.array([
        float(m.get("NonLocStressParam", {}).get("Lc", fallback))
        for m in model.mat_prop
    ])


@dataclasses.dataclass
class NonlocalWeights:
    """Row-normalized nonlocal smoothing operator W (n_elem x n_elem)."""

    csr: "scipy.sparse.csr_matrix"
    ref_lc: float                 # the box half-width used
    lc: np.ndarray                # per-material Lc

    def apply(self, elem_vals: np.ndarray) -> np.ndarray:
        """Smooth per-element values (n_elem,) or (n_elem, k) on host."""
        return self.csr @ elem_vals

    def padded_arrays(self, pad_multiple: int = 8):
        """(cols, w) padded to a common neighbor count K for device apply:
        ``out[i] = sum_k w[i, k] * vals[cols[i, k]]`` with zero-weight
        padding.  Shapes (n_elem, K)."""
        indptr, indices, data = self.csr.indptr, self.csr.indices, self.csr.data
        n = self.csr.shape[0]
        counts = np.diff(indptr)
        K = int(-(-max(int(counts.max()), 1) // pad_multiple) * pad_multiple)
        cols = np.zeros((n, K), dtype=np.int32)
        w = np.zeros((n, K), dtype=data.dtype)
        # vectorized ragged fill: position of each nnz within its row
        pos = np.arange(len(indices)) - np.repeat(indptr[:-1], counts)
        rows = np.repeat(np.arange(n), counts)
        cols[rows, pos] = indices
        w[rows, pos] = data
        return cols, w


def apply_padded(cols, w, elem_vals):
    """Device-side smoothing, ``out[i] = sum_k w[i, k] * vals[cols[i, k]]``:
    a gather, a multiply and a sum over the padded neighbours in a fixed
    order (export path, off the solve's hot loop).  ``cols`` (n, K) int,
    ``w`` (n, K) and ``elem_vals`` (n_elem,) tensors on one device."""
    return (w * elem_vals[cols.long()]).sum(dim=-1)


def build_nonlocal_weights(
    model: ModelData,
    ko: float = KO_DEFAULT,
    lc: Optional[np.ndarray] = None,
) -> NonlocalWeights:
    """Build W over the whole mesh (replaces the per-partition build +
    boundary-element exchanges, partition_mesh.py:1030-1204)."""
    from scipy.sparse import csr_matrix
    from scipy.spatial import cKDTree

    if lc is None:
        lc = material_lc(model)
    ref_lc = float(ko * np.max(lc))

    sctrs = model.sctrs
    vol = model.level.astype(np.float64) ** 3
    n = model.n_elem

    rows_l, cols_l, vals_l = [], [], []
    for m in range(len(model.mat_prop)):
        idx = np.where(model.poly_mat == m)[0]
        if len(idx) == 0:
            continue
        tree = cKDTree(sctrs[idx])
        # box window: Chebyshev (p=inf) ball of radius RefLc
        # (partition_mesh.py:1104-1130 box test)
        nbr_lists = tree.query_ball_point(sctrs[idx], ref_lc, p=np.inf)
        counts = np.fromiter((len(nb) for nb in nbr_lists), dtype=np.int64,
                             count=len(idx))
        cols_m = idx[np.concatenate([np.asarray(nb, dtype=np.int64)
                                     for nb in nbr_lists])]
        rows_m = np.repeat(idx, counts)
        r = np.linalg.norm(sctrs[rows_m] - sctrs[cols_m], axis=1)
        lc_m = lc[m]
        vals_m = np.exp(-0.5 * r * r / (lc_m * lc_m)) * vol[cols_m]
        rows_l.append(rows_m)
        cols_l.append(cols_m)
        vals_l.append(vals_m)

    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    vals = np.concatenate(vals_l)
    W = csr_matrix((vals, (rows, cols)), shape=(n, n))
    # row-normalize (partition_mesh.py:1197)
    rowsum = np.asarray(W.sum(axis=1)).ravel()
    inv = np.where(rowsum > 0, 1.0 / rowsum, 0.0)
    row_of_nnz = np.repeat(np.arange(n), np.diff(W.indptr))
    W = csr_matrix((W.data * inv[row_of_nnz], W.indices, W.indptr), shape=(n, n))
    return NonlocalWeights(csr=W, ref_lc=ref_lc, lc=lc)


# ----------------------------------------------------------------------
# Host-side element stress + nodal averaging (partition-agnostic export path)
# ----------------------------------------------------------------------

def elem_strain_host(model: ModelData, u: np.ndarray) -> np.ndarray:
    """Center-point element strain (n_elem, 6) Voigt from a global
    solution vector, on host: eps = Se . (ce * S.u_e) (reference
    updateElemStrain, pcg_solver.py:601-618)."""
    out = np.zeros((model.n_elem, 6))
    for t, lib in model.elem_lib.items():
        e = np.where(model.elem_type == t)[0]
        if len(e) == 0:
            continue
        Se = lib.get("Se")
        if Se is None:
            raise ValueError(f"element type {t} has no strain-mode matrix Se")
        d = Se.shape[1]
        dofs = _csr_rows(model.elem_dofs_flat, model.elem_dofs_offset, e, d)
        signs = _csr_rows(model.elem_sign_flat, model.elem_dofs_offset, e, d)
        ue = u[dofs]
        ue = np.where(signs, -ue, ue)
        out[e] = (model.ce[e][:, None] * ue) @ Se.T       # (ne, 6)
    return out


def elem_stress_host(model: ModelData, u: np.ndarray) -> np.ndarray:
    """Center-point element stress (n_elem, 6) Voigt from a global solution
    vector, on host: sigma = E * D(nu) . Se . (ce * S.u_e)
    (reference updateElemStrain, pcg_solver.py:601-618 + getNodalPS :755)."""
    from pcg_mpi_solver_tpu_torch.models.element import elasticity_matrix

    E_by_mat = np.array([m["E"] for m in model.mat_prop])
    nu = float(model.mat_prop[0]["Pos"]) if model.mat_prop else 0.2
    D = elasticity_matrix(1.0, nu)
    eps = elem_strain_host(model, u)
    return E_by_mat[model.poly_mat][:, None] * (eps @ D.T)


def nodal_average_host(model: ModelData, elem_vals: np.ndarray) -> np.ndarray:
    """Element-constant values -> averaged nodal field on host (the global
    counterpart of Ops.nodal_average; reference getNodalScalarVar,
    pcg_solver.py:655-727)."""
    reps = np.diff(model.elem_nodes_offset)
    # bincount adds in input order, as the JAX package's np.add.at does
    # (the same bits), in one pass
    sums = np.bincount(model.elem_nodes_flat,
                       weights=np.repeat(elem_vals, reps),
                       minlength=model.n_node)
    counts = np.bincount(model.elem_nodes_flat,
                         minlength=model.n_node).astype(np.float64)
    return sums / (counts + 1e-15)


def von_mises_stress(sig: np.ndarray, axis: int = -1) -> np.ndarray:
    """Von Mises equivalent of Voigt stress (XX,YY,ZZ,YZ,XZ,XY)."""
    s = np.moveaxis(sig, axis, 0)
    s11, s22, s33, s23, s13, s12 = s[0], s[1], s[2], s[3], s[4], s[5]
    return np.sqrt(0.5 * ((s11 - s22) ** 2 + (s22 - s33) ** 2 + (s33 - s11) ** 2)
                   + 3.0 * (s23 ** 2 + s13 ** 2 + s12 ** 2))


def _csr_rows(flat, offset, elems, d):
    """(ne, d) rows of a CSR ragged array for constant-width elements."""
    starts = offset[elems]
    return flat[starts[:, None] + np.arange(d)[None, :]]
