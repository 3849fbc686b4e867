"""Hexahedral element matrices (host-side prep, numpy).

A numpy copy of the parts of ``pcg_mpi_solver_tpu/models/element.py`` the
structured-cube solve needs.  Every cell of a structured cube is a scaled
copy of one unit element, so ``Ke(elem) = Ck(elem) * Ke_unit`` with
``Ck = E * h``.

Node ordering is VTK_HEXAHEDRON: (0,0,0),(1,0,0),(1,1,0),(0,1,0),
(0,0,1),(1,0,1),(1,1,1),(0,1,1); dofs are interleaved (ux,uy,uz) per node,
so element dof ``3 * corner + comp``.  Voigt strain ordering is
(XX, YY, ZZ, YZ, XZ, XY).
"""

from __future__ import annotations

import numpy as np

from pcg_mpi_solver_tpu_torch.utils.quadrature import gauss_points_3d

# Unit-cube corner coordinates in VTK hexahedron order.
HEX_CORNERS = np.array(
    [
        [0.0, 0.0, 0.0],
        [1.0, 0.0, 0.0],
        [1.0, 1.0, 0.0],
        [0.0, 1.0, 0.0],
        [0.0, 0.0, 1.0],
        [1.0, 0.0, 1.0],
        [1.0, 1.0, 1.0],
        [0.0, 1.0, 1.0],
    ]
)

N_NODES = 8
N_DOF = 24


def elasticity_matrix(E: float = 1.0, nu: float = 0.2) -> np.ndarray:
    """6x6 isotropic elasticity matrix in Voigt ordering (XX,YY,ZZ,YZ,XZ,XY)."""
    c = E / ((1.0 + nu) * (1.0 - 2.0 * nu))
    D = np.zeros((6, 6))
    D[:3, :3] = c * nu
    np.fill_diagonal(D[:3, :3], c * (1.0 - nu))
    D[3, 3] = D[4, 4] = D[5, 5] = c * (1.0 - 2.0 * nu) / 2.0
    return D


def shape_grad_natural(xi: np.ndarray) -> np.ndarray:
    """Gradients dN_i/d(xi) of the 8 trilinear shape functions at natural
    coords xi in [-1,1]^3.  Returns (8, 3)."""
    s = 2.0 * HEX_CORNERS - 1.0  # (8,3) of +-1
    g = np.empty((8, 3))
    for i in range(8):
        sx, sy, sz = s[i]
        fx = 0.5 * (1.0 + sx * xi[0])
        fy = 0.5 * (1.0 + sy * xi[1])
        fz = 0.5 * (1.0 + sz * xi[2])
        g[i, 0] = 0.5 * sx * fy * fz
        g[i, 1] = fx * 0.5 * sy * fz
        g[i, 2] = fx * fy * 0.5 * sz
    return g


def b_matrix(dN_dx: np.ndarray) -> np.ndarray:
    """Strain-displacement matrix B (6 x 24) from physical shape gradients
    (8 x 3), Voigt ordering (XX,YY,ZZ,YZ,XZ,XY), interleaved dofs."""
    B = np.zeros((6, N_DOF))
    for i in range(8):
        bx, by, bz = dN_dx[i]
        c = 3 * i
        B[0, c + 0] = bx
        B[1, c + 1] = by
        B[2, c + 2] = bz
        B[3, c + 1] = bz
        B[3, c + 2] = by
        B[4, c + 0] = bz
        B[4, c + 2] = bx
        B[5, c + 0] = by
        B[5, c + 1] = bx
    return B


def hex_stiffness(h: float = 1.0, E: float = 1.0, nu: float = 0.2,
                  n_gauss: int = 2) -> np.ndarray:
    """Element stiffness (24 x 24) of an h-sized cube, full tensor-product
    Gauss integration."""
    D = elasticity_matrix(E, nu)
    Ke = np.zeros((N_DOF, N_DOF))
    J = h / 2.0  # d(x)/d(xi) for the axis-aligned cube (uniform, diagonal)
    detJ = J**3
    pts, wts = gauss_points_3d(n_gauss)
    for xi, w in zip(pts, wts):
        dN_dx = shape_grad_natural(xi) / J
        B = b_matrix(dN_dx)
        Ke += w * B.T @ D @ B * detJ
    return Ke


def hex_mass(h: float = 1.0, rho: float = 1.0, n_gauss: int = 2) -> np.ndarray:
    """Consistent element mass matrix (24 x 24) of an h-sized cube (the
    cube generator's lumped mass diagonal is its row sums)."""
    Me = np.zeros((N_DOF, N_DOF))
    J = h / 2.0
    detJ = J**3
    s = 2.0 * HEX_CORNERS - 1.0
    pts, wts = gauss_points_3d(n_gauss)
    for xi, w in zip(pts, wts):
        N = np.prod(0.5 * (1.0 + s * xi), axis=1)
        Nmat = np.zeros((3, N_DOF))
        for i in range(8):
            Nmat[:, 3 * i : 3 * i + 3] = N[i] * np.eye(3)
        Me += rho * w * (Nmat.T @ Nmat) * detJ
    return Me


def hex_strain_mode(h: float = 1.0) -> np.ndarray:
    """Strain-mode matrix Se (6 x 24): center-point strain = Se @ u_elem."""
    dN_dxi = shape_grad_natural(np.zeros(3))
    dN_dx = dN_dxi / (h / 2.0)
    return b_matrix(dN_dx)


def unit_element_library(nu: float = 0.2):
    """Unit (h=1, E=1) element library for pattern type 0 (the regular cube).

    Returns dict with 'Ke', 'Me', 'Se', 'diagKe' arrays.  Scaling factors per
    element: Ck = E*h (stiffness), Cm = rho*h^3 (mass), Ce = 1/h (strain).
    """
    Ke = hex_stiffness(1.0, 1.0, nu)
    return {
        "Ke": Ke,
        "Me": hex_mass(1.0, 1.0),
        "Se": hex_strain_mode(1.0),
        "diagKe": np.diag(Ke).copy(),
        "n_nodes": N_NODES,
    }
