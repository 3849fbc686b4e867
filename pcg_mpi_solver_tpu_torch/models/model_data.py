"""In-memory global model representation (host-side, numpy).

A numpy copy of ``ModelData`` from ``pcg_mpi_solver_tpu/models/model_data.py``
with the same fields, so a model built by either package can be compared
field by field.  Element connectivity is CSR-style (flat + offsets); dof
ids and reflection sign flags are stored per element-dof.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class ModelData:
    # Counts
    n_elem: int
    n_node: int
    n_dof: int

    # Nodal data
    node_coords: np.ndarray        # (n_node, 3) float64
    F: np.ndarray                  # (n_dof,) reference load vector
    Ud: np.ndarray                 # (n_dof,) prescribed displacement (Dirichlet values)
    Vd: np.ndarray                 # (n_dof,) prescribed velocity (dynamics; zeros here)
    diag_M: np.ndarray             # (n_dof,) lumped mass diagonal
    fixed_dof: np.ndarray          # (n_fixed,) int — Dirichlet-constrained dof ids
    dof_eff: np.ndarray            # (n_eff,) int — effective (free) dof ids

    # Per-element data (CSR-style ragged)
    elem_type: np.ndarray          # (n_elem,) int32 pattern-type id
    elem_nodes_flat: np.ndarray    # (sum nnodes,) int
    elem_nodes_offset: np.ndarray  # (n_elem+1,) int
    elem_dofs_flat: np.ndarray     # (sum ndofs,) int
    elem_dofs_offset: np.ndarray   # (n_elem+1,) int
    elem_sign_flat: np.ndarray     # (sum ndofs,) bool — reflection sign per elem-dof
    ck: np.ndarray                 # (n_elem,) stiffness scale  (= E*h)
    cm: np.ndarray                 # (n_elem,) mass scale       (= rho*h^3)
    ce: np.ndarray                 # (n_elem,) strain scale     (= 1/h)
    level: np.ndarray              # (n_elem,) cell size h
    poly_mat: np.ndarray           # (n_elem,) int material id
    sctrs: np.ndarray              # (n_elem, 3) element centroids

    # Element library: type id -> {'Ke','Me','Se','diagKe','n_nodes'}
    elem_lib: Dict[int, dict]

    # Materials: list of {'E','Pos','Rho'}
    mat_prop: List[dict]

    dt: float = 1.0

    # Boundary faces of the mesh (visualization topology)
    faces_flat: Optional[np.ndarray] = None    # (sum face nnodes,)
    faces_offset: Optional[np.ndarray] = None  # (n_faces+1,)

    # Structured-grid metadata (nx, ny, nz, h) when the mesh is a single
    # uniform block — the structured slab backend (parallel/structured.py)
    # requires it; None for general models.
    grid: Optional[tuple] = None

    # Cohesive interface elements (None for the cube generator); a model
    # that has them is outside the structured slab backend.
    intfc_elems: Optional[List[dict]] = None
