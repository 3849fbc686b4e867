"""The structured cube of the benchmark's inputs (host-side, numpy).

A frozen copy of the port's ``models/synthetic.py::make_cube_model`` and
the helpers it calls; ``cardbench/tests/test_cardbench_inputs.py`` holds
it to the port's generator array for array.
"""

from __future__ import annotations

import numpy as np

from cardbench.inputs.element import unit_element_library
from cardbench.inputs.model_data import ModelData


def _structured_hex_mesh(nx, ny, nz, h):
    """Structured-grid nodes + VTK-hex connectivity: returns (nid,
    coords (n_node, 3), conn (n_elem, 8)); node id = ix + nnx*(iy + nny*iz),
    x fastest."""
    nnx, nny = nx + 1, ny + 1
    n_node = nnx * nny * (nz + 1)
    nid = np.arange(n_node)
    cx = (nid % nnx) * h
    cy = ((nid // nnx) % nny) * h
    cz = (nid // (nnx * nny)) * h
    coords = np.stack([cx, cy, cz], axis=1)
    ex, ey, ez = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                             indexing="ij")
    ex = ex.ravel(order="F"); ey = ey.ravel(order="F"); ez = ez.ravel(order="F")
    n0 = ex + nnx * (ey + nny * ez)
    conn = np.stack(
        [n0, n0 + 1, n0 + 1 + nnx, n0 + nnx,
         n0 + nnx * nny, n0 + 1 + nnx * nny,
         n0 + 1 + nnx + nnx * nny, n0 + nnx + nnx * nny], axis=1)
    return nid, coords, conn


def make_cube_model(
    nx: int,
    ny: int = 0,
    nz: int = 0,
    h: float = 1.0,
    E: float = 1.0,
    nu: float = 0.2,
    rho: float = 1.0,
    load: str = "traction",
    load_value: float = 1.0,
    n_types: int = 1,
    heterogeneous: bool = False,
    seed: int = 0,
) -> ModelData:
    """Structured nx x ny x nz hex mesh of an elastic block.

    - Clamped at x=0 (all 3 dofs fixed).
    - ``load='traction'``: uniform nodal forces +x on the x=L face.
    - ``load='dirichlet'``: prescribed displacement +x on the x=L face
      (exercises the Dirichlet-lifting path).
    - ``n_types > 1``: elements are round-robined over n_types identical
      pattern types (such a model has no ``grid`` and is outside the
      structured slice).
    - ``heterogeneous``: two-phase E field (10x stiff spherical inclusions).
    """
    ny = ny or nx
    nz = nz or nx
    n_elem = nx * ny * nz
    nnx, nny, nnz = nx + 1, ny + 1, nz + 1
    n_node = nnx * nny * nnz
    n_dof = 3 * n_node

    nid, coords, conn = _structured_hex_mesh(nx, ny, nz, h)
    cx = coords[:, 0]

    dofs = (3 * conn[:, :, None] + np.arange(3)[None, None, :]).reshape(n_elem, 24)

    # Materials / heterogeneity.
    rng = np.random.default_rng(seed)
    centers = coords[conn].mean(axis=1)  # element centroids
    if heterogeneous:
        E_elem = np.full(n_elem, E)
        n_incl = max(1, n_elem // 500)
        L = np.array([nx, ny, nz]) * h
        c_incl = rng.uniform(0, 1, (n_incl, 3)) * L
        # Cell-scaled radii: one inclusion per ~500 elements gives a
        # mesh-size-independent ~13% stiff volume fraction.
        r_incl = rng.uniform(1.5, 3.5, n_incl) * h
        # Stamp each sphere only inside its bounding box on the structured
        # grid (element id = ex + nx*(ey + ny*ez)).
        E3 = E_elem.reshape(nz, ny, nx)
        ax = (np.arange(nx) + 0.5) * h
        ay = (np.arange(ny) + 0.5) * h
        az = (np.arange(nz) + 0.5) * h
        for c, r in zip(c_incl, r_incl):
            i0, i1 = np.searchsorted(ax, [c[0] - r, c[0] + r])
            j0, j1 = np.searchsorted(ay, [c[1] - r, c[1] + r])
            k0, k1 = np.searchsorted(az, [c[2] - r, c[2] + r])
            if i0 >= i1 or j0 >= j1 or k0 >= k1:
                continue
            d2 = ((ax[i0:i1][None, None, :] - c[0]) ** 2
                  + (ay[j0:j1][None, :, None] - c[1]) ** 2
                  + (az[k0:k1][:, None, None] - c[2]) ** 2)
            E3[k0:k1, j0:j1, i0:i1][d2 < r * r] = 10.0 * E
        E_elem = E3.reshape(-1)
        mat = np.where(E_elem > E, 1, 0).astype(np.int32)
        mat_prop = [
            {"E": E, "Pos": nu, "Rho": rho, "NonLocStressParam": {"Lc": 2.0 * h}},
            {"E": 10.0 * E, "Pos": nu, "Rho": rho, "NonLocStressParam": {"Lc": 2.0 * h}},
        ]
    else:
        E_elem = np.full(n_elem, E)
        mat = np.zeros(n_elem, dtype=np.int32)
        mat_prop = [{"E": E, "Pos": nu, "Rho": rho, "NonLocStressParam": {"Lc": 2.0 * h}}]

    lib0 = unit_element_library(nu)
    elem_lib = {t: lib0 for t in range(n_types)}
    elem_type = (np.arange(n_elem) % n_types).astype(np.int32)

    ck = E_elem * h                      # stiffness scale
    cm = rho * np.full(n_elem, h**3)     # mass scale
    ce = np.full(n_elem, 1.0 / h)        # strain scale
    level = np.full(n_elem, h)

    # Lumped mass diagonal (bincount: np.add.at is ~50x slower at 10M dofs).
    me_rowsum = lib0["Me"].sum(axis=1)
    diag_M = np.bincount(dofs.ravel(),
                         weights=(cm[:, None] * me_rowsum[None, :]).ravel(),
                         minlength=n_dof)

    # Boundary conditions.
    F = np.zeros(n_dof)
    Ud = np.zeros(n_dof)
    x0_nodes = nid[cx == 0.0]
    fixed = (3 * x0_nodes[:, None] + np.arange(3)[None, :]).ravel()
    xL_nodes = nid[cx == nx * h]
    if load == "traction":
        F[3 * xL_nodes] = load_value  # +x nodal force on the loaded face
    elif load == "dirichlet":
        Ud[3 * xL_nodes] = load_value
        fixed = np.concatenate([fixed, 3 * xL_nodes])
    else:
        raise ValueError(f"unknown load mode {load!r}")
    fixed = np.unique(fixed)
    dof_eff = np.setdiff1d(np.arange(n_dof), fixed, assume_unique=True)

    faces = _boundary_quads(nx, ny, nz, nnx, nny)

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
        elem_nodes_flat=conn.ravel(),
        elem_nodes_offset=np.arange(n_elem + 1) * 8,
        elem_dofs_flat=dofs.ravel(),
        elem_dofs_offset=np.arange(n_elem + 1) * 24,
        elem_sign_flat=np.zeros(n_elem * 24, dtype=bool),
        ck=ck,
        cm=cm,
        ce=ce,
        level=level,
        poly_mat=mat,
        sctrs=centers,
        elem_lib=elem_lib,
        mat_prop=mat_prop,
        dt=1.0,
        faces_flat=faces.ravel(),
        faces_offset=np.arange(len(faces) + 1) * 4,
        grid=(nx, ny, nz, h) if n_types == 1 else None,
    )


def _boundary_quads(nx, ny, nz, nnx, nny) -> np.ndarray:
    """Quad faces on the 6 boundary planes of the structured mesh."""
    def grid_id(i, j, k):
        return i + nnx * (j + nny * k)

    quads = []
    J, K = np.meshgrid(np.arange(ny), np.arange(nz), indexing="ij")
    J, K = J.ravel(), K.ravel()
    for i in (0, nx):  # x faces
        quads.append(np.stack([grid_id(i, J, K), grid_id(i, J + 1, K),
                               grid_id(i, J + 1, K + 1), grid_id(i, J, K + 1)], axis=1))
    I, K = np.meshgrid(np.arange(nx), np.arange(nz), indexing="ij")
    I, K = I.ravel(), K.ravel()
    for j in (0, ny):  # y faces
        quads.append(np.stack([grid_id(I, j, K), grid_id(I + 1, j, K),
                               grid_id(I + 1, j, K + 1), grid_id(I, j, K + 1)], axis=1))
    I, J = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    I, J = I.ravel(), J.ravel()
    for k in (0, nz):  # z faces
        quads.append(np.stack([grid_id(I, J, k), grid_id(I + 1, J, k),
                               grid_id(I + 1, J + 1, k), grid_id(I, J + 1, k)], axis=1))
    return np.concatenate(quads, axis=0)


#: the generator this folder finds by the name "cube"
make_model = make_cube_model
