"""Stress/strain export fields: principal values + nodal field assembly.

Port of ``pcg_mpi_solver_tpu/ops/stress.py`` in torch ops (the JAX package
leaves this export path to XLA; here it is plain tensor code on the
solution's device).  The chain:

    u -> eps = Se.(ce*S.u)  per element       (reference updateElemStrain
                                               pcg_solver.py:601-618)
      -> sigma = E*D(nu).eps                  (getNodalPS :755)
      -> principal values (trig invariant method, descending)
                                              (file_operations.py:251-301)
      -> node-averaged fields, the shared nodes' sums and counts assembled
         across parts                         (getNodalScalarVar :655-727)

Each backend's ``Ops`` gives ``elem_strain`` (a list of (B, 6, N) Voigt
strains in its own element layout: the general backend's buckets, the
slab's cell grid, the hybrid backend's buckets then levels),
``elem_scale`` (the matching (B, N) moduli) and ``nodal_average`` (a
list of (B, k, N) element values -> (P, k, n_node_loc)); the sums are
fixed-order gathers on every backend, so two exports on the card give the
same bits.
"""

from __future__ import annotations

import math

import torch

from pcg_mpi_solver_tpu_torch.models.element import elasticity_matrix


def principal_values(voigt: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Principal values of symmetric 3x3 tensors in Voigt form
    (XX,YY,ZZ,YZ,XZ,XY) along ``dim``; returns 3 values, descending.

    Closed-form trigonometric (Cardano) method, branch-free and batched,
    the reference's algorithm (file_operations.py:274-301)."""
    v = torch.movedim(voigt, dim, 0)
    s11, s22, s33, s23, s13, s12 = v[0], v[1], v[2], v[3], v[4], v[5]
    I1 = s11 + s22 + s33
    I2 = s11 * s22 + s22 * s33 + s33 * s11 - s12**2 - s23**2 - s13**2
    I3 = (s11 * s22 * s33 - s11 * s23**2 - s22 * s13**2 - s33 * s12**2
          + 2 * s12 * s23 * s13)
    scale = v.abs().amax(dim=0)
    J2 = I1 * I1 - 3 * I2 + 1e-24 * scale  # guard (reference :283)
    J2 = J2.clamp_min(0.0)
    # Clamp AFTER the 1.5-power with the dtype's tiny: J2**1.5 underflows
    # to 0 for near-degenerate tensors and 0/0 would make the all-equal
    # case NaN (the exactly-zero initial frame).  With denom clamped,
    # phi_arg -> 0 and f -> 0, giving p_i = I1/3.
    tiny = torch.finfo(v.dtype).tiny
    denom = (J2**1.5).clamp_min(tiny)
    phi_arg = (0.5 * (2 * I1**3 - 9 * I1 * I2 + 27 * I3) / denom).clamp(
        -1.0, 1.0)
    phi = torch.arccos(phi_arg) / 3.0
    f = (2.0 / 3.0) * torch.sqrt(J2)
    p0 = I1 / 3.0 + f * torch.cos(phi)
    p1 = I1 / 3.0 + f * torch.cos(phi + 2.0 * math.pi / 3.0)
    p2 = I1 / 3.0 + f * torch.cos(phi + 4.0 * math.pi / 3.0)
    stacked = torch.stack([p0, p1, p2])
    pmax = stacked.amax(dim=0)
    pmin = stacked.amin(dim=0)
    pmid = I1 - pmax - pmin
    return torch.movedim(torch.stack([pmax, pmid, pmin]), 0, dim)


def eqv_strain(eps: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Von Mises equivalent strain from a Voigt strain vector (engineering
    shear), the JAX package's 'ES'."""
    e = torch.movedim(eps, dim, 0)
    e11, e22, e33, g23, g13, g12 = e[0], e[1], e[2], e[3], e[4], e[5]
    dev = ((e11 - e22)**2 + (e22 - e33)**2 + (e33 - e11)**2) / 2.0
    shear = 3.0 / 4.0 * (g23**2 + g13**2 + g12**2)
    return (2.0 / 3.0) * torch.sqrt(dev + shear)


def nodal_export_fields(ops, data: dict, un: torch.Tensor, export_vars,
                        nu: float) -> dict:
    """Every requested nodal export field of the solution ``un`` (P,
    n_loc): {var: (P, n_node_loc)} for var in D, ES, PS1-3, PE1-3
    (reference exportContourData, pcg_solver.py:861-889)."""
    want_pe = any(v.startswith("PE") for v in export_vars)
    want_ps = any(v.startswith("PS") for v in export_vars)
    want_es = "ES" in export_vars
    want_d = "D" in export_vars
    out = {}

    eps_list = None
    if want_pe or want_ps or want_es:
        eps_list = ops.elem_strain(data, un)

    requests = []   # (name, per-block list of (B, k, N))
    if want_d:
        # damage scaffold: Omega = 0 (reference config_TypeGroupList
        # initializes it so, partition_mesh.py:482)
        requests.append(("D", [torch.zeros_like(c)[:, None, :]
                               for c in ops.elem_scale(data)]))
    if want_es:
        requests.append(("ES", [eqv_strain(e)[:, None] for e in eps_list]))
    if want_pe:
        requests.append(("PE", [principal_values(e) for e in eps_list]))
    if want_ps:
        D = torch.as_tensor(elasticity_matrix(1.0, nu),
                            dtype=eps_list[0].dtype,
                            device=eps_list[0].device)
        sig_list = [E[:, None] * torch.einsum("st,btn->bsn", D, e)
                    for E, e in zip(ops.elem_scale(data), eps_list)]
        requests.append(("PS", [principal_values(s) for s in sig_list]))

    for name, vals in requests:
        avg = ops.nodal_average(data, vals)     # (P, k, n_node_loc)
        if name in ("D", "ES"):
            out[name] = avg[:, 0]
        else:
            for i in range(3):
                out[f"{name}{i + 1}"] = avg[:, i]
    return out
