"""The model container of the benchmark's inputs (host-side, numpy).

A frozen copy of the port's ``models/model_data.py::ModelData``, field for
field; the harness hands its fields to the port's own type.
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

    # Octree lattice metadata (set by models/octree.py): {"leaves": (n_elem,
    # 4) lattice origin + size in finest units, "dims": (X, Y, Z),
    # "node_keys": (n_node,) lattice keys, "strides": (stride_y, stride_z),
    # "brick_type": type id of the pure 8-node pattern (or None),
    # "brick_corners": (8, 3) corner offsets in that type's node order}.
    # It is what the hybrid backend (parallel/hybrid.py) reads; the
    # general backend ignores it.
    octree: Optional[dict] = None

    # Cohesive interface elements: each a zero-thickness 4+4-node quad
    # {'NodeIdList': (2, 4) int [side-a nodes, side-b nodes], 'adj_elem':
    # a volume element adjacent to side a (anchors partitioning), 'kn',
    # 'kt': normal/tangential penalty stiffness per unit area, 'area',
    # 'normal_axis': 0/1/2}.  A model that has them is outside the
    # structured slab backend.
    intfc_elems: Optional[List[dict]] = None

    # Slab-ingest view (the MDF reader's, ROADMAP queue 1 item 11): the
    # per-element arrays cover only the slab's elements and elem_ids[i] is
    # element i's global id.  None for a full model (every generator here).
    elem_ids: Optional[np.ndarray] = None
    glob_n_elem: Optional[int] = None

    def elem_nodes(self, e: int) -> np.ndarray:
        return self.elem_nodes_flat[
            self.elem_nodes_offset[e]:self.elem_nodes_offset[e + 1]]

    def elem_dofs(self, e: int) -> np.ndarray:
        return self.elem_dofs_flat[
            self.elem_dofs_offset[e]:self.elem_dofs_offset[e + 1]]

    def elem_signs(self, e: int) -> np.ndarray:
        return self.elem_sign_flat[
            self.elem_dofs_offset[e]:self.elem_dofs_offset[e + 1]]

    def interface_springs(self):
        """Interface elements flattened to per-dof penalty springs: each
        coincident node pair contributes, per component c, a spring of
        stiffness area/4 * (kn if c == normal_axis else kt) on the jump
        u_a - u_b.  Returns flat (dof_a, dof_b, k, adj_elem) arrays, empty
        without interface elements."""
        if not self.intfc_elems:
            z = np.zeros(0, dtype=np.int64)
            return z, z, np.zeros(0), z
        dof_a, dof_b, k, adj = [], [], [], []
        for ie in self.intfc_elems:
            nodes = np.asarray(ie["NodeIdList"])
            per_pair = ie["area"] / nodes.shape[1]
            for c in range(3):
                kc = per_pair * (ie["kn"] if c == ie["normal_axis"]
                                 else ie["kt"])
                dof_a.append(3 * nodes[0] + c)
                dof_b.append(3 * nodes[1] + c)
                k.append(np.full(nodes.shape[1], kc))
                adj.append(np.full(nodes.shape[1], ie["adj_elem"],
                                   dtype=np.int64))
        return (np.concatenate(dof_a), np.concatenate(dof_b),
                np.concatenate(k), np.concatenate(adj))
