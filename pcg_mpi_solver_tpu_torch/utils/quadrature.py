"""Numerical integration tables for the hexahedral element library.

A numpy copy of ``pcg_mpi_solver_tpu/utils/quadrature.py`` (the port
imports nothing of the JAX package): Gauss-Legendre nodes/weights on
[-1, 1] and their tensor-product rule on the reference cube.
"""

from __future__ import annotations

import numpy as np


def gauss_table(n_points: int):
    """Gauss-Legendre nodes/weights on [-1, 1]; exact for degree 2n-1."""
    if n_points < 1:
        raise ValueError("n_points must be >= 1")
    ni, wi = np.polynomial.legendre.leggauss(n_points)
    return ni, wi


def gauss_points_3d(n_points: int):
    """Tensor-product Gauss rule on the reference cube [-1,1]^3.

    Returns (points (n^3, 3), weights (n^3,)) — the integration layout for
    hexahedral pattern elements."""
    ni, wi = gauss_table(n_points)
    X, Y, Z = np.meshgrid(ni, ni, ni, indexing="ij")
    WX, WY, WZ = np.meshgrid(wi, wi, wi, indexing="ij")
    pts = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)
    w = (WX * WY * WZ).ravel()
    return pts, w
