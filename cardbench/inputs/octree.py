"""Synthetic octree models with real transition pattern types (host-side).

The reference's entire problem class is octree meshes from CT images: cells
fall into a library of <=144 geometric pattern types (partition_mesh.py:1074
asserts ``0<=Type<=143``), each with a precomputed unit stiffness ``Ke``
(loaded from Ke.mat at partition_mesh.py:546-547), grouped per type for the
batched matvec (config_TypeGroupList, partition_mesh.py:420-493), with
boolean per-dof sign vectors handling mirrored pattern instances
(pcg_solver.py:277-280 flips signs around the Ke matmul).  The bundled
concrete model is absent from the snapshot, so this module builds the same
kind of mesh from scratch:

- a 2:1-balanced octree over a block (refinement driven by stiff spherical
  inclusions, CT-concrete style), strong balance over all 26 neighbors;
- hanging nodes are REAL dofs: a coarse cell whose face/edge touches finer
  neighbors includes the shared mid-edge / mid-face nodes, so elements have
  varying node counts (8..26) and dof counts d (24..78);
- each distinct (edge-mask, face-mask) configuration is a pattern type with
  its own unit ``Ke``/``Me``/``Se`` built by a conforming macro-element
  construction: the unit cube is split into 8 trilinear octants whose
  27-lattice corner values interpolate from the element's nodes (absent
  mid-nodes take the average of their edge/face neighbors — both cells
  sharing a face use the same rule, so the basis is C0-conforming across
  coarse/coarse and coarse/fine interfaces);
- with ``canonicalize=True`` patterns are reduced modulo the 8 axis
  reflections: mirrored instances reuse the canonical ``Ke`` with a slot
  permutation plus per-dof sign flips (u-component along each reflected
  axis), exercising the reference's sign machinery with real semantics.

Scalings match the rest of the framework: ``Ck = E*h``, ``Cm = rho*h^3``,
``Ce = 1/h`` per element (element.py).

``faces_flat`` holds EVERY element face (subdivided faces as their 4
sub-quads), so interior faces appear exactly twice and the exporter's
Boundary mode can keep incidence-1 faces (reference export_vtk.py:105-113).

A frozen copy of the port's ``models/octree.py::make_octree_model`` and
everything it calls; ``cardbench/tests/test_cardbench_inputs.py`` holds
it to the port's generator array for array.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from cardbench.inputs.element import (
    HEX_CORNERS, b_matrix, hex_mass, hex_stiffness, shape_grad_natural)
from cardbench.inputs.model_data import ModelData

# ----------------------------------------------------------------------
# The 27-point lattice of the unit cube at half spacing: p in {0,1,2}^3.
# ----------------------------------------------------------------------

_CORNER_P = (2 * HEX_CORNERS).astype(np.int64)           # (8, 3), VTK order

# Edge midpoints: exactly one coordinate == 1.  Face centers: exactly two.
_EDGE_P = np.array([p for p in np.ndindex(3, 3, 3)
                    if sum(c == 1 for c in p) == 1], dtype=np.int64)
_FACE_P = np.array([p for p in np.ndindex(3, 3, 3)
                    if sum(c == 1 for c in p) == 2], dtype=np.int64)
_CENTER_P = np.array([1, 1, 1], dtype=np.int64)
N_EDGE, N_FACE = len(_EDGE_P), len(_FACE_P)              # 12, 6


def _lat_id(p) -> int:
    return int(p[0] + 3 * p[1] + 9 * p[2])


_CORNER_IDS = [_lat_id(p) for p in _CORNER_P]
_EDGE_IDS = [_lat_id(p) for p in _EDGE_P]
_FACE_IDS = [_lat_id(p) for p in _FACE_P]

# For an absent edge midpoint: average of its two edge-end corners.
_EDGE_ENDS = []
for p in _EDGE_P:
    ax = int(np.where(p == 1)[0][0])
    lo, hi = p.copy(), p.copy()
    lo[ax], hi[ax] = 0, 2
    _EDGE_ENDS.append((_lat_id(lo), _lat_id(hi)))

# For an absent face center: average of the values at its 4 edge midpoints
# (each itself a dof or a corner average).  Both cells sharing the face see
# the same mask for it, so this rule is conforming by construction.
_FACE_EDGES = []
for p in _FACE_P:
    ax = int(np.where(p != 1)[0][0])
    mids = []
    for t in np.where(np.arange(3) != ax)[0]:
        for v in (0, 2):
            q = p.copy()
            q[t] = v
            mids.append(_lat_id(q))
    _FACE_EDGES.append(mids)


def _slot_layout(mask: int) -> Tuple[List[int], Dict[int, int]]:
    """Node slots of a pattern: 8 corners, then present edge mids (edge
    order), then present face centers.  Returns (lattice ids per slot,
    lattice id -> slot)."""
    lat = list(_CORNER_IDS)
    for e in range(N_EDGE):
        if mask >> e & 1:
            lat.append(_EDGE_IDS[e])
    for f in range(N_FACE):
        if mask >> (N_EDGE + f) & 1:
            lat.append(_FACE_IDS[f])
    return lat, {l: s for s, l in enumerate(lat)}


def _interp_matrix(mask: int) -> np.ndarray:
    """A (27 x n_nodes): value at each lattice point as a combination of the
    pattern's nodal values (scalar; per-component via kron with I3)."""
    lat, slot_of = _slot_layout(mask)
    nn = len(lat)
    A = np.zeros((27, nn))
    for lid in _CORNER_IDS:
        A[lid, slot_of[lid]] = 1.0
    for e, lid in enumerate(_EDGE_IDS):
        if lid in slot_of:
            A[lid, slot_of[lid]] = 1.0
        else:
            a, b = _EDGE_ENDS[e]
            A[lid] = 0.5 * (A[a] + A[b])
    for f, lid in enumerate(_FACE_IDS):
        if lid in slot_of:
            A[lid, slot_of[lid]] = 1.0
        else:
            A[lid] = np.mean([A[m] for m in _FACE_EDGES[f]], axis=0)
    A[_lat_id(_CENTER_P)] = np.mean([A[l] for l in _FACE_IDS], axis=0)
    return A


def transition_element(mask: int, nu: float = 0.2) -> dict:
    """Unit (h=1, E=1, rho=1) matrices for one pattern type.

    Macro assembly: 8 trilinear octants (size 1/2), octant corner values
    from the interpolation matrix; Ke = sum_o G_o^T Ke_oct G_o.  SPD with
    exactly 6 rigid-body zero-energy modes by construction."""
    A = _interp_matrix(mask)
    nn = A.shape[1]
    d = 3 * nn
    Ke_oct = hex_stiffness(0.5, 1.0, nu)
    Me_oct = hex_mass(0.5, 1.0)
    Ke = np.zeros((d, d))
    Me = np.zeros((d, d))
    Se = np.zeros((6, d))
    I3 = np.eye(3)
    for o in np.ndindex(2, 2, 2):
        corner_lids = [_lat_id(np.asarray(o, dtype=np.int64) + c)
                       for c in HEX_CORNERS.astype(np.int64)]
        G = np.kron(A[corner_lids], I3)              # (24, d)
        Ke += G.T @ Ke_oct @ G
        Me += G.T @ Me_oct @ G
        # Center-point strain: the macro center (1,1,1) is the corner of
        # every octant at local 0/1 coords (1-o); average the 8 one-sided
        # gradients (reference Se role, partition_mesh.py:580).
        xi = 2.0 * (1.0 - np.asarray(o, dtype=float)) - 1.0
        dN_dx = shape_grad_natural(xi) / 0.25
        Se += b_matrix(dN_dx) @ G / 8.0
    return {"Ke": Ke, "Me": Me, "Se": Se, "diagKe": np.diag(Ke).copy(),
            "n_nodes": nn, "mask": mask}


# ----------------------------------------------------------------------
# Reflection canonicalization (the reference's mirrored-pattern signs).
# ----------------------------------------------------------------------

def _reflect_lattice(p: np.ndarray, r: Tuple[int, int, int]) -> np.ndarray:
    q = p.copy()
    for ax in range(3):
        if r[ax]:
            q[..., ax] = 2 - q[..., ax]
    return q


def _mask_perm(r: Tuple[int, int, int]) -> np.ndarray:
    """Bit permutation of the 18-bit (edges, faces) mask under reflection."""
    perm = np.zeros(N_EDGE + N_FACE, dtype=np.int64)
    eid = {l: i for i, l in enumerate(_EDGE_IDS)}
    fid = {l: i for i, l in enumerate(_FACE_IDS)}
    for e, p in enumerate(_EDGE_P):
        perm[e] = eid[_lat_id(_reflect_lattice(p, r))]
    for f, p in enumerate(_FACE_P):
        perm[N_EDGE + f] = N_EDGE + fid[_lat_id(_reflect_lattice(p, r))]
    return perm


_REFLECTIONS = [(rx, ry, rz) for rx in (0, 1) for ry in (0, 1) for rz in (0, 1)]
_MASK_PERMS = {r: _mask_perm(r) for r in _REFLECTIONS}


def _apply_mask_perm(mask: int, r) -> int:
    perm = _MASK_PERMS[r]
    out = 0
    for b in range(N_EDGE + N_FACE):
        if mask >> b & 1:
            out |= 1 << int(perm[b])
    return out


def canonical_mask(mask: int) -> Tuple[int, Tuple[int, int, int]]:
    """(canonical mask, reflection r with perm_r(mask) == canonical)."""
    best, best_r = None, None
    for r in _REFLECTIONS:
        m = _apply_mask_perm(mask, r)
        if best is None or m < best:
            best, best_r = m, r
    return best, best_r


# ----------------------------------------------------------------------
# Octree construction
# ----------------------------------------------------------------------

_DIRS = [d for d in np.ndindex(3, 3, 3) if d != (1, 1, 1)]


class _Octree:
    """2:1-balanced leaf set over an (nx0, ny0, nz0) root grid, integer
    coordinates in finest-level units (cell at level l has size
    2**(max_level - l))."""

    def __init__(self, nx0, ny0, nz0, max_level):
        self.U = 2 ** max_level
        self.dims = (nx0 * self.U, ny0 * self.U, nz0 * self.U)
        self.leaves = set()
        for z in range(0, self.dims[2], self.U):
            for y in range(0, self.dims[1], self.U):
                for x in range(0, self.dims[0], self.U):
                    self.leaves.add((x, y, z, self.U))

    def find(self, x, y, z) -> Optional[Tuple[int, int, int, int]]:
        """Leaf covering the unit cell at (x, y, z), or None outside."""
        if not (0 <= x < self.dims[0] and 0 <= y < self.dims[1]
                and 0 <= z < self.dims[2]):
            return None
        s = 1
        while s <= self.U:
            key = (x // s * s, y // s * s, z // s * s, s)
            if key in self.leaves:
                return key
            s *= 2
        raise AssertionError(f"no leaf covers {(x, y, z)}")

    def split(self, leaf, created=None) -> list:
        """Split a leaf into 8 children; ripple-refine coarser neighbors so
        the 26-neighbor 2:1 balance is preserved (any coarser leaf touching
        this one covers the entire adjacent region in its direction, so one
        sample point per direction suffices).  Returns every leaf created
        (children + ripple children) so callers need not diff the leaf set
        — diffing was O(n) per split, O(n^2) over a refinement sweep."""
        if created is None:
            created = []
        x, y, z, s = leaf
        assert s >= 2, "cannot split finest-level cell"
        self.leaves.remove(leaf)
        h = s // 2
        for dz in (0, h):
            for dy in (0, h):
                for dx in (0, h):
                    child = (x + dx, y + dy, z + dz, h)
                    self.leaves.add(child)
                    created.append(child)
        for d in _DIRS:
            qx = x - 1 if d[0] == 0 else (x + s if d[0] == 2 else x)
            qy = y - 1 if d[1] == 0 else (y + s if d[1] == 2 else y)
            qz = z - 1 if d[2] == 0 else (z + s if d[2] == 2 else z)
            nb = self.find(qx, qy, qz)
            if nb is not None and nb[3] > s and nb in self.leaves:
                self.split(nb, created)
        return created


def make_octree_model(
    nx0: int = 2,
    ny0: int = 2,
    nz0: int = 2,
    h0: float = 1.0,
    max_level: int = 2,
    E: float = 1.0,
    nu: float = 0.2,
    rho: float = 1.0,
    load: str = "traction",
    load_value: float = 1.0,
    n_incl: int = 3,
    incl_stiff: float = 10.0,
    seed: int = 0,
    canonicalize: bool = True,
    refine_centers: Optional[np.ndarray] = None,
    refine_radii: Optional[np.ndarray] = None,
) -> ModelData:
    """Graded octree block: stiff spherical inclusions, cells cut by an
    inclusion surface refined to ``max_level``, strong 2:1 balance.

    - clamped at x=0 (all nodes on the plane, hanging ones included);
    - ``load='traction'``: uniform pressure ``load_value`` (force/area) on
      the x=L face, distributed area-consistently over the face quads;
    - ``load='dirichlet'``: prescribed +x displacement on the x=L face.
    - ``canonicalize``: reduce the pattern library modulo the 8 axis
      reflections (mirrored instances get sign vectors); ``False`` keeps one
      type per raw mask with all-zero signs (useful as a cross-check).
    """
    rng = np.random.default_rng(seed)
    tree = _Octree(nx0, ny0, nz0, max_level)
    X, Y, Z = tree.dims
    hf = h0 / tree.U                                 # finest cell size
    L = np.array([X, Y, Z]) * hf

    if refine_centers is None:
        refine_centers = rng.uniform(0.15, 0.85, (n_incl, 3)) * L
        refine_radii = rng.uniform(0.12, 0.25, n_incl) * min(L)
    elif refine_radii is None:
        raise ValueError("refine_centers given without refine_radii")
    refine_centers = np.atleast_2d(np.asarray(refine_centers, dtype=float))
    refine_radii = np.atleast_1d(np.asarray(refine_radii, dtype=float))

    def cut_by_surface(x, y, z, s) -> bool:
        lo = np.array([x, y, z]) * hf
        hi = lo + s * hf
        for c, r in zip(refine_centers, refine_radii):
            near = np.clip(c, lo, hi)
            dmin = np.linalg.norm(near - c)
            dmax = np.linalg.norm(np.maximum(hi - c, c - lo))
            if dmin <= r <= dmax:
                return True
        return False

    work = [lf for lf in tree.leaves]
    while work:
        leaf = work.pop()
        if leaf not in tree.leaves or leaf[3] < 2:
            continue
        if cut_by_surface(*leaf):
            work.extend(tree.split(leaf))

    leaves = np.array(sorted(tree.leaves), dtype=np.int64)   # (n_elem, 4)
    n_elem = len(leaves)

    # ---- global nodes: all leaf corners -------------------------------
    stride_y, stride_z = X + 1, (X + 1) * (Y + 1)

    def encode(pts):                                  # pts (..., 3) ints
        return pts[..., 0] + stride_y * pts[..., 1] + stride_z * pts[..., 2]

    # corner lattice coords are {0,2} -> offsets {0,s} for every size incl. 1
    corners = (leaves[:, None, :3]
               + _CORNER_P[None, :, :] // 2 * leaves[:, None, 3:4])
    node_keys = np.unique(encode(corners).ravel())
    n_node = len(node_keys)
    n_dof = 3 * n_node
    coords = np.stack([node_keys % stride_y,
                       (node_keys // stride_y) % (Y + 1),
                       node_keys // stride_z], axis=1) * hf

    # ---- per-leaf pattern masks (membership in the node set is exact:
    # a mid-edge/mid-face node exists iff a finer neighbor created it) ----
    masks = np.zeros(n_elem, dtype=np.int64)
    half = leaves[:, 3] // 2
    big = leaves[:, 3] >= 2
    if big.any():
        EF_P = np.concatenate([_EDGE_P, _FACE_P])     # (18, 3)
        pts = (leaves[big, None, :3]
               + EF_P[None] * half[big, None, None])  # (nb, 18, 3)
        keys = encode(pts)
        pos = np.minimum(np.searchsorted(node_keys, keys), n_node - 1)
        present = node_keys[pos] == keys
        masks[big] = (present.astype(np.int64)
                      << np.arange(18, dtype=np.int64)).sum(axis=1)

    # ---- pattern library (canonical or raw); per-unique-mask lookup ----
    uniq_masks = np.unique(masks)
    if canonicalize:
        canon_u = {int(m): canonical_mask(int(m)) for m in uniq_masks}
    else:
        canon_u = {int(m): (int(m), (0, 0, 0)) for m in uniq_masks}
    upos = np.searchsorted(uniq_masks, masks)
    elem_mask = np.asarray([canon_u[int(m)][0] for m in uniq_masks],
                           dtype=np.int64)[upos]
    refl_u = np.asarray([c[1] for c in
                         (canon_u[int(m)] for m in uniq_masks)],
                        dtype=np.int64)                # (nu, 3)
    elem_refl = refl_u[upos]                           # (n_elem, 3)

    type_masks = sorted(set(int(m) for m in elem_mask))
    mask_to_type = {m: t for t, m in enumerate(type_masks)}
    elem_lib = {t: transition_element(m, nu) for t, m in enumerate(type_masks)}
    elem_type = np.array([mask_to_type[int(m)] for m in elem_mask],
                         dtype=np.int32)

    # ---- connectivity: canonical slot order mapped through the
    # reflection (reflections are involutions: physical lattice point of
    # canonical slot l-hat is r(l-hat)).  Vectorized per
    # (mask, reflection, size-class) group — a few hundred groups at most,
    # each a batched encode + searchsorted. ----------------------------
    lat_cache: Dict[int, np.ndarray] = {}
    for m in set(int(v) for v in elem_mask):
        lat, _ = _slot_layout(m)
        lat_cache[m] = np.array([[l % 3, (l // 3) % 3, l // 9] for l in lat],
                                dtype=np.int64)
    nn_of_mask = {m: len(v) for m, v in lat_cache.items()}
    nn_per = np.asarray([nn_of_mask[int(m)] for m in elem_mask])
    elem_nodes_offset = np.concatenate([[0], np.cumsum(nn_per)])
    elem_dofs_offset = 3 * elem_nodes_offset

    conn_flat = np.zeros(int(nn_per.sum()), dtype=np.int64)
    sign_nodes = np.zeros((int(nn_per.sum()), 3), dtype=bool)
    refl_code = elem_refl @ np.array([1, 2, 4])
    group_key = (elem_mask * 16 + refl_code * 2 + big.astype(np.int64))
    g_order = np.argsort(group_key, kind="stable")
    _, g_starts = np.unique(group_key[g_order], return_index=True)
    for a, b in zip(g_starts, np.append(g_starts[1:], len(g_order))):
        sel = g_order[a:b]
        m = int(elem_mask[sel[0]])
        r = tuple(int(v) for v in elem_refl[sel[0]])
        pts = lat_cache[m]
        phys = _reflect_lattice(pts, r)                # (nn, 3)
        if big[sel[0]]:
            lat_off = phys[None] * half[sel, None, None]
        else:
            lat_off = phys[None] // 2 * leaves[sel, None, 3:4]
        keys = encode(leaves[sel, None, :3] + lat_off)  # (ng, nn)
        nodes = np.searchsorted(node_keys, keys)
        # fail fast if a slot's lattice point is not a mesh node (the old
        # dict lookup raised KeyError; searchsorted would silently alias)
        if not np.array_equal(node_keys[np.minimum(nodes, n_node - 1)], keys):
            raise AssertionError(
                f"pattern slot lattice point missing from the node set "
                f"(mask {m}, reflection {r})")
        flat_pos = (np.repeat(elem_nodes_offset[sel], len(pts))
                    + np.tile(np.arange(len(pts)), len(sel)))
        conn_flat[flat_pos] = nodes.reshape(-1)
        for ax in range(3):
            if r[ax]:
                sign_nodes[flat_pos, ax] = True

    dof_flat_all = (3 * conn_flat[:, None]
                    + np.arange(3)[None, :]).reshape(-1)
    sign_flat_all = sign_nodes.reshape(-1)

    # ---- materials ----------------------------------------------------
    sctrs = (leaves[:, :3] + leaves[:, 3:4] / 2.0) * hf
    E_elem = np.full(n_elem, E)
    for c, r in zip(refine_centers, refine_radii):
        inside = np.linalg.norm(sctrs - c, axis=1) < r
        E_elem[inside] = incl_stiff * E
    mat = (E_elem > E).astype(np.int32)
    mat_prop = [
        {"E": E, "Pos": nu, "Rho": rho, "NonLocStressParam": {"Lc": 2.0 * hf}},
        {"E": incl_stiff * E, "Pos": nu, "Rho": rho,
         "NonLocStressParam": {"Lc": 2.0 * hf}},
    ]

    h_elem = leaves[:, 3] * hf
    ck = E_elem * h_elem
    cm = rho * h_elem ** 3
    ce = 1.0 / h_elem

    # ---- mass diagonal (vectorized per type) -------------------------
    diag_M = np.zeros(n_dof)
    for t, lib in elem_lib.items():
        sel = np.where(elem_type == t)[0]
        if not len(sel):
            continue
        d = lib["Ke"].shape[0]
        me_rowsum = lib["Me"].sum(axis=1)              # (d,)
        dofs = dof_flat_all[
            (elem_dofs_offset[sel, None]
             + np.arange(d)[None, :])]                 # (nt, d)
        np.add.at(diag_M, dofs.reshape(-1),
                  (cm[sel, None] * me_rowsum[None]).reshape(-1))

    # ---- faces (ALL element faces; subdivided ones as 4 sub-quads so
    # interior incidence is exactly 2 — reference export_vtk.py:105-113) --
    face_quads = _collect_faces(leaves, masks, node_keys, encode)

    # ---- BCs ----------------------------------------------------------
    F = np.zeros(n_dof)
    Ud = np.zeros(n_dof)
    on_x0 = np.where(coords[:, 0] == 0.0)[0]
    fixed = (3 * on_x0[:, None] + np.arange(3)[None, :]).ravel()
    xL = X * hf
    if load == "traction":
        for quad, area in _boundary_quads_at(face_quads, coords, axis=0,
                                             value=xL):
            F[3 * quad] += load_value * area / 4.0
    elif load == "dirichlet":
        on_xL = np.where(coords[:, 0] == xL)[0]
        Ud[3 * on_xL] = load_value
        fixed = np.concatenate([fixed, 3 * on_xL])
    else:
        raise ValueError(f"unknown load mode {load!r}")
    fixed = np.unique(fixed)
    dof_eff = np.setdiff1d(np.arange(n_dof), fixed, assume_unique=True)

    return ModelData(
        n_elem=n_elem,
        n_node=n_node,
        n_dof=n_dof,
        node_coords=coords,
        F=F,
        Ud=Ud,
        Vd=np.zeros(n_dof),
        diag_M=diag_M,
        fixed_dof=fixed,
        dof_eff=dof_eff,
        elem_type=elem_type,
        elem_nodes_flat=conn_flat,
        elem_nodes_offset=elem_nodes_offset,
        elem_dofs_flat=dof_flat_all,
        elem_dofs_offset=elem_dofs_offset,
        elem_sign_flat=sign_flat_all,
        ck=ck,
        cm=cm,
        ce=ce,
        level=h_elem,
        poly_mat=mat,
        sctrs=sctrs,
        elem_lib=elem_lib,
        mat_prop=mat_prop,
        dt=1.0,
        faces_flat=np.asarray(face_quads, dtype=np.int64).ravel(),
        faces_offset=np.arange(len(face_quads) + 1) * 4,
        grid=None,
        octree=_octree_meta(leaves, (X, Y, Z), node_keys,
                            (stride_y, stride_z), mask_to_type),
    )


def _octree_meta(leaves, dims, node_keys, strides, mask_to_type):
    """Lattice metadata of the hybrid level-grid backend
    (``parallel/hybrid.py``).  The "brick" pattern is mask 0 (no mid-edge/face
    nodes); its canonical reflection is the identity (canonical_mask(0) ==
    (0, (0,0,0))), so brick connectivity has zero signs and its node order
    is _slot_layout(0)'s corner order recorded here."""
    brick_type = mask_to_type.get(0)
    brick_corners = None
    if brick_type is not None:
        lat, _ = _slot_layout(0)
        brick_corners = np.array(
            [[l % 3, (l // 3) % 3, l // 9] for l in lat], dtype=np.int64) // 2
    return {
        "leaves": leaves,
        "dims": tuple(int(d) for d in dims),
        "node_keys": node_keys,
        "strides": tuple(int(s) for s in strides),
        "brick_type": brick_type,
        "brick_corners": brick_corners,
    }


# Face f of a cell (lattice point p with two coords == 1): the 4 corner
# lattice points of the face, in a consistent quad order.
def _face_corner_lats(p: np.ndarray) -> np.ndarray:
    ax = int(np.where(p != 1)[0][0])
    t1, t2 = [t for t in range(3) if t != ax]
    quad = []
    for a, b in ((0, 0), (2, 0), (2, 2), (0, 2)):
        q = p.copy()
        q[t1], q[t2] = a, b
        quad.append(q)
    return np.array(quad)


_FACE_CORNERS = [_face_corner_lats(p) for p in _FACE_P]


def _collect_faces(leaves, masks, node_keys, encode) -> np.ndarray:
    """All element faces as node-id quads, vectorized per (face, case):
    subdivided faces (mask bit set) as their 4 sub-quads."""
    big = leaves[:, 3] >= 2
    h2 = np.maximum(leaves[:, 3] // 2, 1)
    quad_batches = []
    order = []                      # (elem id, face id, sub id) for ordering

    def lookup(keys):
        ids = np.searchsorted(node_keys, keys)
        if not np.array_equal(
                node_keys[np.minimum(ids, len(node_keys) - 1)], keys):
            raise AssertionError("face corner missing from the node set")
        return ids

    for f, p in enumerate(_FACE_P):
        corners = _FACE_CORNERS[f]                      # (4, 3)
        sub = big & ((masks >> (N_EDGE + f)) & 1).astype(bool)
        # whole faces (coarse lattice for size-1 cells)
        sel = np.where(~sub)[0]
        if len(sel):
            lat = np.where(big[sel, None, None], corners[None] * h2[sel, None, None],
                           corners[None] // 2 * leaves[sel, None, 3:4])
            quad_batches.append(lookup(encode(leaves[sel, None, :3] + lat)))
            order.append(sel * 24 + f * 4)
        # subdivided faces: 4 sub-quads each
        sel = np.where(sub)[0]
        for k in range(4):
            if not len(sel):
                continue
            q0 = corners[k]
            q1 = (corners[k] + corners[(k + 1) % 4]) // 2
            q3 = (corners[k] + corners[(k - 1) % 4]) // 2
            lat = np.stack([q0, q1, p, q3])             # (4, 3)
            quad_batches.append(lookup(encode(
                leaves[sel, None, :3] + lat[None] * h2[sel, None, None])))
            order.append(sel * 24 + f * 4 + k)
    quads = np.concatenate(quad_batches, axis=0)
    # restore per-element, per-face order (stable downstream exports)
    return quads[np.argsort(np.concatenate(order), kind="stable")]


def _boundary_quads_at(face_quads, coords, axis: int, value: float):
    """Quads whose 4 nodes all lie on the plane coords[axis] == value, with
    their areas, deduplicated (interior faces appear twice)."""
    on = np.abs(coords[face_quads, axis] - value) < 1e-12
    sel = face_quads[on.all(axis=1)]
    if not len(sel):
        return
    _, first = np.unique(np.sort(sel, axis=1), axis=0, return_index=True)
    sel = sel[np.sort(first)]
    pts = coords[sel]                                   # (n, 4, 3)
    areas = np.linalg.norm(
        np.cross(pts[:, 1] - pts[:, 0], pts[:, 3] - pts[:, 0]), axis=1)
    for quad, area in zip(sel, areas):
        yield quad, float(area)


#: the generator this folder finds by the name "octree"
make_model = make_octree_model
