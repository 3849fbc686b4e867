"""Matrix-free geometric multigrid V-cycle preconditioner
(``precond="mg"``).

Port of ``pcg_mpi_solver_tpu/ops/mg.py`` for the structured slab and the
general backends.
The design is the JAX package's:

* **Levels** — the fine cell lattice (``ModelData.grid``) is coarsened by
  2 while every dim stays even, down to ``MG_MIN_COARSE_DIM`` cells (or
  for exactly ``mg_levels`` levels).  Each coarse level is a uniform
  brick grid with a per-cell ``ck`` (volume-averaged fine stiffness ×
  the level's h): the same matrix-free stencil at every level.
* **Coarse levels are whole grids** — in the JAX package they are
  replicated on every device so the coarse cycle needs no collective; the
  port runs on one device, where they simply live beside the fine level.
  Their matvecs are torch ops (slices, one (24, 24) einsum, translate
  adds), as they are XLA ops in the JAX package; the fine level's go
  through the structured matvec kernel.
* **Chebyshev–Jacobi smoother** — a fixed-degree polynomial in ``D^-1 A``
  with eigenvalue bounds estimated once at setup (``lam``), so the cycle
  has no inner products and reads nothing back from the device.
* **A fixed operator** — the cycle's shape is static and every reduction
  in it runs in a fixed order: the restrictions are gathers of the
  transposed prolongation stencil (:func:`restriction_gather`), not
  scatter-adds, so two applies to the same vector give the same bits on
  the card too (a float ``index_add_`` there uses atomics).  Plain CG
  needs that one fixed SPD preconditioner.

Per V-cycle the fine level costs ``2 * mg_degree`` matvecs (degree - 1
pre-smoothing from zero, one defect, degree post-smoothing).  A block of
right-hand sides (R, P, n_loc) runs one V-cycle for all its columns, each
on its own: every level's ops carry the columns on a leading axis (the
JAX package vmaps the cycle, ``ops/mg.py:639-647``), so a fine matvec is
one kernel launch for the block and no level loops over columns.

Host-side setup (:func:`build_mg_host`) is numpy and gives the JAX
package's ``MGSetup.tree`` field for field, so a hierarchy built by either
package goes to the device through :func:`tree_from_numpy`.  The lattice
is a structured grid's (``model.grid``) or an octree's (``model.octree``:
its leaves paint the unit-lattice stiffness field, and the hierarchy
serves the general backend, whose node rows are ``Ops._as_node3``'s).
The setup ends in :func:`install_lam_and_report`, as the JAX package's
does: the ``mg_setup`` event and ``validate.check_mg_interval``'s
warning.  The recovery ladder's demotion to scalar Jacobi is
:func:`fallback_operand`.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import List, Optional, Tuple

import numpy as np
import torch

from pcg_mpi_solver_tpu_torch.models.element import hex_stiffness
from pcg_mpi_solver_tpu_torch.ops.structured_matvec import CORNERS

# ---------------------------------------------------------------------------
# Tuning constants (the JAX package's; the level count and the smoothing
# degree are SolverConfig fields, mg_levels and mg_smooth_degree)
# ---------------------------------------------------------------------------

#: safety factor on the power-iteration lambda_max estimate: Chebyshev
#: smoothing is SPD-preserving only for b >= true lambda_max, and power
#: iteration converges from below
MG_LAM_SAFETY = 1.2
#: smoother interval [lam/alpha, lam]
MG_SMOOTH_ALPHA = 4.0
#: coarsest-level "solve": one fixed Chebyshev sweep over [lam/alpha, lam]
MG_COARSE_ALPHA = 30.0
MG_COARSE_DEGREE = 10
#: power-iteration matvecs for the per-level lambda_max estimates
MG_POWER_ITERS = 16
#: auto-coarsening stops at this many cells per dim (or when a dim is odd)
MG_MIN_COARSE_DIM = 2
MG_MAX_LEVELS = 8

_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


class MGSetupError(ValueError):
    """The model/config cannot build an MG hierarchy (named reason)."""


# ---------------------------------------------------------------------------
# Host-side hierarchy construction (numpy)
# ---------------------------------------------------------------------------

def fine_lattice(model) -> Tuple[Optional[Tuple[int, int, int]],
                                 Optional[np.ndarray]]:
    """The fine cell-lattice dims and per-node integer lattice coords of a
    lattice-structured model, or ``(None, None)``.  Octree models carry
    exact lattice metadata (``model.octree``: ``dims``, ``strides``,
    ``node_keys``); structured-grid models (``model.grid``) recover the
    coords from ``node_coords / h``.  The one eligibility probe of the
    preflight checks and the hierarchy builder."""
    ot = getattr(model, "octree", None)
    if ot:
        X, Y, Z = (int(d) for d in ot["dims"])
        sy, sz = (int(s) for s in ot["strides"])
        keys = np.asarray(ot["node_keys"])
        lat = np.stack([keys % sy, (keys // sy) % (Y + 1), keys // sz],
                       axis=1).astype(np.int64)
        return (X, Y, Z), lat
    if getattr(model, "grid", None) is None:
        return None, None
    nx, ny, nz, h = model.grid
    nc = np.asarray(model.node_coords, float)
    latf = (nc - nc.min(axis=0)) / float(h)
    lat = np.rint(latf).astype(np.int64)
    if np.abs(latf - lat).max() > 1e-6:
        return None, None
    return (int(nx), int(ny), int(nz)), lat


def plan_levels(dims, n_levels: int = 0) -> List[Tuple[int, int, int]]:
    """Coarse-level cell dims, finest-coarse first.  Coarsens by 2 while
    every dim stays even, down to ``MG_MIN_COARSE_DIM`` (auto) or for
    exactly ``n_levels`` levels.  Raises :class:`MGSetupError` when the
    lattice cannot coarsen at least once, or not ``n_levels`` times."""
    d = np.asarray(dims, np.int64)
    out: List[Tuple[int, int, int]] = []
    while len(out) < (n_levels or MG_MAX_LEVELS):
        if np.any(d % 2):
            break
        d = d // 2
        out.append(tuple(int(v) for v in d))
        if not n_levels and int(d.max()) <= MG_MIN_COARSE_DIM:
            break
    if not out:
        raise MGSetupError(
            f"precond='mg' cannot coarsen the {tuple(int(v) for v in dims)}"
            " cell lattice: every dim must be even for at least one "
            "2:1 coarsening (fewer than 2 levels)")
    if n_levels and len(out) < n_levels:
        raise MGSetupError(
            f"SolverConfig.mg_levels={n_levels} but the "
            f"{tuple(int(v) for v in dims)} lattice only supports "
            f"{len(out)} coarsening(s)")
    return out


def _ravel(dims_c, pts) -> np.ndarray:
    """Flat node id on a (cx, cy, cz)-cell grid: C-order over (ix, iy,
    iz), the ordering of :func:`_to_grid` / :func:`_to_flat`."""
    cx, cy, cz = dims_c
    return (pts[..., 0] * (cy + 1) + pts[..., 1]) * (cz + 1) + pts[..., 2]


def trilinear_transfer(lat, dims_c, scale: int):
    """Trilinear prolongation stencil of nodes at integer lattice coords
    ``lat`` (units of the finer lattice) from the coarse node grid of
    ``dims_c`` cells (coarse spacing ``scale`` finer units).

    Returns ``(gidx, gw)``: (n, 8) flat coarse node ids and weights with
    ``fine = sum_k gw[:, k] * coarse[gidx[:, k]]``.  Restriction is the
    exact transpose, which keeps the V-cycle symmetric."""
    lat = np.asarray(lat, np.float64)
    dims_c = tuple(int(v) for v in dims_c)
    pos = lat / float(scale)
    cell = np.minimum(np.floor(pos).astype(np.int64),
                      np.asarray(dims_c, np.int64) - 1)
    cell = np.maximum(cell, 0)
    frac = pos - cell
    gidx = np.zeros((len(lat), 8), np.int64)
    gw = np.zeros((len(lat), 8), np.float64)
    for k, (dx, dy, dz) in enumerate(CORNERS):
        w = (frac[:, 0] if dx else 1.0 - frac[:, 0]) \
            * (frac[:, 1] if dy else 1.0 - frac[:, 1]) \
            * (frac[:, 2] if dz else 1.0 - frac[:, 2])
        gidx[:, k] = _ravel(dims_c, cell + np.asarray((dx, dy, dz)))
        gw[:, k] = w
    return gidx.astype(np.int32), gw


def _level_diag_np(diag_Ke, ck) -> np.ndarray:
    """Assembled nodal diagonal of one brick level:
    ``diag[c, node] = sum over adjacent cells of ck * diag_Ke[3a + c]``."""
    cx, cy, cz = ck.shape
    d = np.zeros((3, cx + 1, cy + 1, cz + 1))
    for a, (dx, dy, dz) in enumerate(CORNERS):
        for c in range(3):
            d[c, dx:dx + cx, dy:dy + cy, dz:dz + cz] \
                += diag_Ke[3 * a + c] * ck
    return d


def _level_matvec_np(Ke, ck, effg, xg) -> np.ndarray:
    """Level stencil matvec in numpy (setup-time power iteration only;
    the device twin is :func:`_level_matvec`)."""
    cx, cy, cz = ck.shape
    xg = xg * effg
    slots = [xg[:, dx:dx + cx, dy:dy + cy, dz:dz + cz]
             for dx, dy, dz in CORNERS]
    u = np.concatenate(slots, axis=0).reshape(24, -1)
    v = (Ke @ (ck.reshape(-1)[None] * u)).reshape(24, cx, cy, cz)
    y = np.zeros_like(xg)
    for a, (dx, dy, dz) in enumerate(CORNERS):
        y[:, dx:dx + cx, dy:dy + cy, dz:dz + cz] += v[3 * a:3 * a + 3]
    return y * effg


def _np_level_lam(Ke, ck, effg, idiag, iters: int = MG_POWER_ITERS) -> float:
    """Power-iteration lambda_max estimate of ``D^-1 A`` on one coarse
    level."""
    x = effg.copy()
    n = np.linalg.norm(x)
    if n == 0:
        return 1.0
    x /= n
    lam = 1.0
    for _ in range(iters):
        y = idiag * _level_matvec_np(Ke, ck, effg, x)
        lam = float(np.linalg.norm(y))
        if lam <= 0 or not np.isfinite(lam):
            return 1.0
        x = y / lam
    return lam


def _np_level_lam_min(Ke, ck, effg, idiag, lam_max: float,
                      iters: int = 2 * MG_POWER_ITERS) -> float:
    """Shifted power iteration for lambda_min of ``D^-1 A`` on the
    coarsest level (the degenerate-interval diagnostic)."""
    x = effg.copy()
    n = np.linalg.norm(x)
    if n == 0:
        return lam_max
    x /= n
    mu = 0.0
    for _ in range(iters):
        y = lam_max * (effg * x) - idiag * _level_matvec_np(
            Ke, ck, effg, x)
        mu = float(np.linalg.norm(y))
        if mu <= 0 or not np.isfinite(mu):
            return lam_max
        x = y / mu
    return max(lam_max - mu, 0.0)


@dataclasses.dataclass
class MGSetup:
    """Host product of the hierarchy build: the ``data["mg"]`` tree
    (numpy), its structural meta and the setup diagnostics."""

    tree: dict
    meta: dict              # {"levels", "degree", "dims"}
    coarse_lams: List[float]
    lam_min_coarse: float


def level_replicated_dofs(level_dims) -> List[int]:
    """Per-coarse-level dof counts (3 dofs a node on a full node grid):
    the quantity ``SolverConfig.mg_max_replicated_dofs`` caps."""
    return [3 * (cx + 1) * (cy + 1) * (cz + 1)
            for cx, cy, cz in level_dims]


def apply_replication_cutoff(level_dims, n_levels: int,
                             max_replicated_dofs: int):
    """Truncate the planned hierarchy before the cumulative coarse-level
    dofs exceed ``max_replicated_dofs`` (0 = no cutoff).  Raises
    :class:`MGSetupError` when not even the first coarse level fits, or
    when an explicit ``mg_levels`` request cannot be honoured under the
    cutoff."""
    if max_replicated_dofs <= 0:
        return level_dims
    sizes = level_replicated_dofs(level_dims)
    keep, cum = [], 0
    for dims, sz in zip(level_dims, sizes):
        if cum + sz > max_replicated_dofs:
            break
        cum += sz
        keep.append(dims)
    if not keep:
        raise MGSetupError(
            f"precond='mg': the first coarse level ({level_dims[0]} "
            f"cells, {sizes[0]} replicated dofs) already exceeds "
            f"SolverConfig.mg_max_replicated_dofs="
            f"{max_replicated_dofs} — every coarse level is replicated "
            "on every device, so this hierarchy would make replication "
            "the memory ceiling; raise the cutoff or use "
            "precond='jacobi'|'block3'")
    if n_levels and len(keep) < n_levels:
        raise MGSetupError(
            f"SolverConfig.mg_levels={n_levels} needs "
            f"{sum(sizes[:n_levels])} replicated coarse dofs, over the "
            f"mg_max_replicated_dofs={max_replicated_dofs} cutoff "
            f"(only {len(keep)} level(s) fit); lower mg_levels or raise "
            "the cutoff")
    return keep


def build_mg_host(model, pm, n_levels: int = 0, degree: int = 2,
                  max_replicated_dofs: int = 0) -> MGSetup:
    """Build the whole MG hierarchy on the host from the model lattice and
    the partition's node map ``pm.node_gid`` (P, n_node_loc), whose node
    order is ``ops._as_node3``'s.  ``tree["lam"][0]``, the fine level's
    bound, is a placeholder until :func:`estimate_fine_lam` gives it."""
    if int(model.n_dof) != 3 * int(model.n_node):
        raise MGSetupError(
            "precond='mg' needs the vector (3-dof/node) problem class; "
            f"this model has n_dof={model.n_dof}, n_node={model.n_node}")
    if not getattr(pm, "node_layout", True):
        raise MGSetupError(
            "precond='mg' needs the node-contiguous dof layout "
            "(PartitionedModel.node_layout); this partition broke it "
            "(e.g. node-less spring ghost dofs)")
    dims, node_lat = fine_lattice(model)
    if dims is None:
        raise MGSetupError(
            "precond='mg' needs lattice metadata (ModelData.grid or "
            ".octree); this model has neither — use precond='jacobi'")
    level_dims = apply_replication_cutoff(
        plan_levels(dims, n_levels), n_levels, max_replicated_dofs)

    # unit-lattice stiffness-density field E(x)
    X, Y, Z = dims
    E = np.asarray(model.ck, float) * np.asarray(model.ce, float)
    if getattr(model, "octree", None):
        # every octree leaf (x, y, z, size) paints its s^3 unit cells
        leaves = np.asarray(model.octree["leaves"])
        E_unit = np.zeros((X, Y, Z))
        for s in np.unique(leaves[:, 3]):
            sel = leaves[:, 3] == s
            lx, ly, lz = (leaves[sel, 0], leaves[sel, 1], leaves[sel, 2])
            for dx in range(int(s)):
                for dy in range(int(s)):
                    for dz in range(int(s)):
                        E_unit[lx + dx, ly + dy, lz + dz] = E[sel]
        hf = float(model.level.min() / leaves[:, 3].min())
    else:
        # structured grid: element id x-fastest
        E_unit = E.reshape(Z, Y, X).transpose(2, 1, 0)
        hf = float(model.grid[3])

    # per-node Dirichlet mask on the fine lattice
    fixed = np.zeros(model.n_dof, bool)
    fixed[np.asarray(model.fixed_dof)] = True
    fixed3 = fixed.reshape(model.n_node, 3)
    fine_keys = _ravel(dims, node_lat)
    order = np.argsort(fine_keys)
    keys_sorted = fine_keys[order]

    Ke = _brick_Ke(model)
    diag_Ke = np.diag(Ke).copy()

    levels = []
    coarse_lams: List[float] = []
    lam_min_coarse = 0.0
    for li, dc in enumerate(level_dims):
        s = 2 ** (li + 1)
        cx, cy, cz = dc
        ck_l = (E_unit.reshape(cx, s, cy, s, cz, s)
                .mean(axis=(1, 3, 5)) * (s * hf))
        # Dirichlet injection: a coarse node is fixed iff a fine node at
        # the same lattice position is fixed there
        eff_l = np.ones((3, cx + 1, cy + 1, cz + 1))
        cn = np.stack(np.meshgrid(np.arange(cx + 1), np.arange(cy + 1),
                                  np.arange(cz + 1), indexing="ij"),
                      axis=-1).reshape(-1, 3)
        ckeys = _ravel(dims, cn * s)
        pos = np.searchsorted(keys_sorted, ckeys)
        pos_c = np.minimum(pos, len(keys_sorted) - 1)
        present = keys_sorted[pos_c] == ckeys
        nid = order[pos_c]
        for c in range(3):
            fx = np.zeros(len(cn), bool)
            fx[present] = fixed3[nid[present], c]
            eff_l[c] = np.where(fx, 0.0, 1.0).reshape(cx + 1, cy + 1,
                                                      cz + 1)
        dg = _level_diag_np(diag_Ke, ck_l)
        idiag = np.where((dg > 0) & (eff_l > 0),
                         1.0 / np.where(dg > 0, dg, 1.0), 0.0)
        lam = MG_LAM_SAFETY * _np_level_lam(Ke, ck_l, eff_l, idiag)
        coarse_lams.append(lam)
        lev = {"ck": ck_l, "eff": eff_l,
               "idiag": idiag.reshape(3, -1).T.copy()}   # flat (n, 3)
        if li + 1 < len(level_dims):
            # down-transfer: this level's nodes from the next coarser grid
            gidx, gw = trilinear_transfer(cn, level_dims[li + 1], 2)
            lev["gidx"], lev["gw"] = gidx, gw
        else:
            lam_min_coarse = _np_level_lam_min(
                Ke, ck_l, eff_l, idiag, lam / MG_LAM_SAFETY)
        levels.append(lev)

    # fine -> first-coarse transfer, in the part-local node layout
    gid = np.asarray(pm.node_gid)                     # (P, n_node_loc)
    P, nnl = gid.shape
    valid = gid >= 0
    lat_loc = np.zeros((P, nnl, 3), np.int64)
    lat_loc[valid] = node_lat[gid[valid]]
    gidx, gw = trilinear_transfer(lat_loc.reshape(-1, 3), level_dims[0], 2)
    gidx = gidx.reshape(P, nnl, 8)
    gw = gw.reshape(P, nnl, 8)
    gw[~valid] = 0.0                                  # padded local slots

    tree = {
        "fine": {"gidx": gidx, "gw": gw},
        "levels": levels,
        "Ke": Ke,
        # [fine, coarse_1, ..., coarse_L]; slot 0 waits for
        # estimate_fine_lam
        "lam": np.asarray([0.0] + coarse_lams, np.float64),
    }
    meta = {"levels": len(level_dims), "degree": int(degree),
            "dims": [int(v) for v in dims]}
    return MGSetup(tree=tree, meta=meta, coarse_lams=coarse_lams,
                   lam_min_coarse=lam_min_coarse)


def _brick_Ke(model) -> np.ndarray:
    """The 24x24 unit (h=1, E=1) brick stiffness every coarse level
    rediscretizes with: the octree's brick type, else the model's own
    8-node brick when it has one, else the canonical hex element."""
    ot = getattr(model, "octree", None)
    bt = ot.get("brick_type") if ot else None
    if bt is not None and bt in model.elem_lib:
        return np.asarray(model.elem_lib[bt]["Ke"], float)
    for lib in model.elem_lib.values():
        if np.asarray(lib["Ke"]).shape == (24, 24):
            return np.asarray(lib["Ke"], float)
    nu = float(model.mat_prop[0]["Pos"]) if model.mat_prop else 0.2
    return hex_stiffness(1.0, 1.0, nu)


def coarse_dofs(meta) -> int:
    """First-coarse vector length (nodes x 3) of a hierarchy with
    structural ``meta`` (the JAX package's restriction psum payload)."""
    if not meta:
        return 0
    half = [d // 2 for d in meta["dims"]]
    return 3 * (half[0] + 1) * (half[1] + 1) * (half[2] + 1)


# ---------------------------------------------------------------------------
# Device tree
# ---------------------------------------------------------------------------

def restriction_gather(gidx, gw, n_coarse: int):
    """The restriction R = P^T of a prolongation stencil ``(gidx, gw)``
    ((..., 8) coarse ids and weights, rows flattened in order) as a gather:
    ``ridx`` (n_coarse, K) fine row ids and ``rw`` their weights, so that
    ``coarse[c] = sum_k rw[c, k] * fine[ridx[c, k]]``.  Each coarse node
    lists its nonzero-weight rows in ascending row order; short lists are
    padded with weight 0 on row 0.  A zero weight adds nothing to the JAX
    package's scatter-add either, and ids outside ``n_coarse`` are dropped
    as there."""
    gidx = np.asarray(gidx).reshape(-1, 8)
    gw = np.asarray(gw).reshape(-1, 8)
    rows, ks = np.nonzero(gw)                         # row-major order
    cols = gidx[rows, ks].astype(np.int64)
    keep = (cols >= 0) & (cols < n_coarse)
    rows, ks, cols = rows[keep], ks[keep], cols[keep]
    order = np.argsort(cols, kind="stable")
    rows, ks, cols = rows[order], ks[order], cols[order]
    counts = np.bincount(cols, minlength=n_coarse)
    width = max(int(counts.max(initial=0)), 1)
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(len(cols)) - start[cols]
    ridx = np.zeros((n_coarse, width), np.int64)
    rw = np.zeros((n_coarse, width), np.float64)
    ridx[cols, slot] = rows
    rw[cols, slot] = gw[rows, ks]
    return ridx, rw


def tree_from_numpy(tree: dict, dtype: torch.dtype, device) -> dict:
    """The port's ``data["mg"]`` from an ``MGSetup.tree`` of numpy arrays
    (built by :func:`build_mg_host` or by the JAX package): float leaves
    as ``dtype`` tensors on ``device``, index arrays as int64 tensors, each
    transfer with its restriction gather (:func:`restriction_gather`).
    ``lam`` stays a host numpy vector of ``dtype``: its values are the
    scalars of the Chebyshev recurrence, and reading them from the device
    would stall every cycle."""
    def put(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype,
                               device=device).contiguous()

    def put_index(a):
        return torch.as_tensor(np.asarray(a, np.int64),
                               device=device).contiguous()

    def transfer(src, n_next):
        ridx, rw = restriction_gather(src["gidx"], src["gw"], n_next)
        return {"gidx": put_index(src["gidx"]), "gw": put(src["gw"]),
                "ridx": put_index(ridx), "rw": put(rw)}

    levels = tree["levels"]
    out_levels = []
    for li, lev in enumerate(levels):
        d = {"ck": put(lev["ck"]), "eff": put(lev["eff"]),
             "idiag": put(lev["idiag"])}
        if "gidx" in lev:
            d.update(transfer(lev, levels[li + 1]["idiag"].shape[0]))
        out_levels.append(d)
    return {"fine": transfer(tree["fine"], levels[0]["idiag"].shape[0]),
            "levels": out_levels,
            "Ke": put(tree["Ke"]),
            "lam": np.asarray(tree["lam"], np.float64).astype(
                _NP_DTYPES[dtype])}


def cast_tree(tree, dtype: torch.dtype):
    """A device tree with its float leaves at ``dtype`` (tensors, and the
    host ``lam`` vector); index leaves pass through."""
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cast_tree(v, dtype) for v in tree]
    if isinstance(tree, np.ndarray):
        return (tree.astype(_NP_DTYPES[dtype])
                if np.issubdtype(tree.dtype, np.floating) else tree)
    return tree.to(dtype) if tree.is_floating_point() else tree


# ---------------------------------------------------------------------------
# The V-cycle (torch ops; the fine matvecs through ops.matvec)
# ---------------------------------------------------------------------------

def _to_grid(flat: torch.Tensor, dims_c) -> torch.Tensor:
    """([R,] n_nodes, 3) flat level vector -> ([R,] 3, cx+1, cy+1, cz+1)
    grid view (node id C-order over (ix, iy, iz), as :func:`_ravel`)."""
    cx, cy, cz = dims_c
    return flat.reshape(*flat.shape[:-2], cx + 1, cy + 1, cz + 1,
                        3).movedim(-1, -4)


def _to_flat(grid: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_to_grid`."""
    return grid.movedim(-4, -1).reshape(*grid.shape[:-4], -1, 3)


def _level_matvec(Ke, ck, effg, x_flat):
    """Coarse-level assembled stencil matvec, flat ([R,] n, 3) -> ([R,] n,
    3), eff-masked in and out: 8 slices -> one (24, 24) einsum -> 8
    translate adds in corner order (the JAX package's ``_level_matvec``);
    a block's columns ride the leading axis of every op."""
    cx, cy, cz = ck.shape
    xg = _to_grid(x_flat, (cx, cy, cz)) * effg
    u = torch.cat([xg[..., dx:dx + cx, dy:dy + cy, dz:dz + cz]
                   for dx, dy, dz in CORNERS], dim=-4)
    v = torch.einsum("de,...exyz->...dxyz", Ke, ck * u)
    y = torch.zeros_like(xg)
    for a, (dx, dy, dz) in enumerate(CORNERS):
        y[..., dx:dx + cx, dy:dy + cy, dz:dz + cz] += v[..., 3 * a:3 * a + 3,
                                                         :, :, :]
    return _to_flat(y * effg)


def _cheb_coeffs(lam, degree: int, alpha: float):
    """The Chebyshev recurrence's scalars for the interval [lam/alpha,
    lam], in lam's own precision (a numpy float32 or float64, as the JAX
    package computes them on the device): ``theta`` and, for each of the
    degree - 1 later steps, the two coefficients of ``d``."""
    f = type(lam)
    b = lam
    a = lam / f(alpha)
    theta = f(0.5) * (b + a)
    delta = f(0.5) * (b - a)
    sigma = theta / delta
    rho = f(1.0) / sigma
    steps = []
    for _ in range(1, int(degree)):
        rho_new = f(1.0) / (f(2.0) * sigma - rho)
        steps.append((float(rho_new * rho), float(f(2.0) * rho_new / delta)))
        rho = rho_new
    return float(theta), steps


def _cheb_smooth(amul, idiag_mul, r, z0, lam, degree: int, alpha: float):
    """Fixed-degree Chebyshev–Jacobi smoothing toward ``A z = r`` on
    [lam/alpha, lam].  ``z0=None`` declares a zero start (degree - 1
    matvecs; degree from a warm start).  No inner products."""
    theta, steps = _cheb_coeffs(lam, degree, alpha)
    if z0 is None:
        res, z = r, None
    else:
        res, z = r - amul(z0), z0
    d = idiag_mul(res) / theta
    for c_d, c_res in steps:
        z = d if z is None else z + d
        res = r - amul(z)
        d = c_d * d + c_res * idiag_mul(res)
    return d if z is None else z + d


def _restrict(t: dict, s_flat: torch.Tensor) -> torch.Tensor:
    """R s: the fixed-order gather of the transposed stencil, ([R,] n_fine,
    3) -> ([R,] n_coarse, 3)."""
    return (t["rw"][..., None] * s_flat[..., t["ridx"], :]).sum(dim=-2)


def _prolong(t: dict, zc: torch.Tensor) -> torch.Tensor:
    """P zc: (..., 8) stencil -> (..., 3); ``zc`` ([R,] n_coarse, 3)."""
    return (t["gw"][..., None] * zc[..., t["gidx"], :]).sum(dim=-2)


def _coarse_vcycle(mg: dict, lidx: int, rc: torch.Tensor, degree: int):
    """Recursive V-cycle over the coarse levels: Chebyshev pre/post
    smoothing, trilinear transfers, a fixed Chebyshev sweep on the
    coarsest level."""
    lev = mg["levels"][lidx]
    lam = mg["lam"][lidx + 1]
    Ke = mg["Ke"]
    idiag = lev["idiag"]

    def amul(v):
        return _level_matvec(Ke, lev["ck"], lev["eff"], v)

    def idiag_mul(v):
        return idiag * v

    if lidx == len(mg["levels"]) - 1:
        return _cheb_smooth(amul, idiag_mul, rc, None, lam,
                            MG_COARSE_DEGREE, MG_COARSE_ALPHA)
    z = _cheb_smooth(amul, idiag_mul, rc, None, lam, degree,
                     MG_SMOOTH_ALPHA)
    s = rc - amul(z)
    zc = _coarse_vcycle(mg, lidx + 1, _restrict(lev, s), degree)
    z = z + _prolong(lev, zc)
    return _cheb_smooth(amul, idiag_mul, rc, z, lam, degree,
                        MG_SMOOTH_ALPHA)


def _vcycle(ops, data: dict, m: dict, r: torch.Tensor):
    """One symmetric V-cycle on a fine column (P, n_loc) or on a block of
    columns (R, P, n_loc), each column on its own: every level's ops
    carry the block on their leading axis, so each fine smoothing matvec
    is one kernel launch for the whole block."""
    mg = data["mg"]
    eff = data["eff"]
    degree = int(ops.mg_degree)
    lam = mg["lam"][0]
    idiag = m["mg_diag"]                  # eff-masked fine inverse diag

    def amul(v):
        return eff * ops.matvec(data, v)

    def idiag_mul(v):
        return idiag * v

    # pre-smooth from zero: degree - 1 matvecs
    z = _cheb_smooth(amul, idiag_mul, r, None, lam, degree, MG_SMOOTH_ALPHA)
    # defect, owner-weighted, restricted into the first coarse level
    s = r - amul(z)
    s3 = ops._as_node3(s) * data["node_weight"][..., None]
    sc = _restrict(mg["fine"], s3.reshape(*r.shape[:-2], -1, 3))
    zc = _coarse_vcycle(mg, 0, sc, degree)
    # prolongation back to the part-local fine layout: a local gather
    z = z + eff * ops._from_node3(_prolong(mg["fine"], zc))
    # post-smooth with the same polynomial (the symmetry requirement)
    return _cheb_smooth(amul, idiag_mul, r, z, lam, degree, MG_SMOOTH_ALPHA)


def mg_apply(ops, data: dict, m: dict, r: torch.Tensor) -> torch.Tensor:
    """Apply the MG preconditioner: ``z = M^-1 r`` for one column (P,
    n_loc) or a block (R, P, n_loc) (then ``data`` is the tree of
    ``parallel.structured.block_data`` for that width).  ``m`` is
    ``make_prec(ops, data, "mg")``; the hierarchy rides ``data["mg"]``.
    With ``m["fb"]`` set (the recovery ladder's demotion,
    :func:`fallback_operand`) the apply is scalar Jacobi on
    ``m["mg_diag"]`` instead of the V-cycle (JAX ``ops/mg.py:673-680``);
    ``fb`` is a host int, so the choice costs no device read."""
    if m.get("fb"):
        return (m["mg_diag"] * r).to(r.dtype)
    return _vcycle(ops, data, m, r)


def fallback_operand(inv: torch.Tensor) -> dict:
    """The recovery ladder's demoted operand for an mg-configured solver:
    the scalar-Jacobi inverse in the mg operand's shape with the ``fb``
    switch set, so :func:`mg_apply` takes the scalar branch."""
    return {"mg_diag": inv, "fb": 1}


# ---------------------------------------------------------------------------
# Fine-level eigenvalue bound and its install
# ---------------------------------------------------------------------------

def estimate_fine_lam(ops, data: dict, iters: int = MG_POWER_ITERS) -> float:
    """lambda_max estimate of ``D^-1 A`` on the partitioned fine level:
    ``iters`` power-iteration matvecs on ``ops``/``data`` (the solver's
    float64 operator), queued on the device and read back once.  Returns
    the safety-scaled bound for ``data["mg"]["lam"][0]``."""
    eff = data["eff"]
    w = data["weight"] * eff
    dd = ops.dot_dtype
    diag = ops.diag(data)
    one = torch.ones((), dtype=diag.dtype, device=diag.device)
    idiag = torch.where((eff > 0) & (diag != 0),
                        1.0 / torch.where(diag != 0, diag, one),
                        torch.zeros_like(one))
    x = (eff.to(dd) / torch.clamp(torch.sqrt(ops.wdot(w, eff, eff)),
                                  min=1e-30)).to(eff.dtype)
    lam = torch.ones((), dtype=dd, device=eff.device)
    for _ in range(iters):
        y = idiag * (eff * ops.matvec(data, x))
        lam = torch.sqrt(ops.wdot(w, y, y))
        x = (y.to(dd) / torch.clamp(lam, min=1e-30)).to(x.dtype)
    lam = float(lam)
    if not np.isfinite(lam) or lam <= 0:
        lam = 1.0
    return MG_LAM_SAFETY * lam


def install_lam_and_report(setup: MGSetup, lam_fine: float, *, trees,
                           recorder, wall_s: float,
                           cached: bool) -> np.ndarray:
    """The end of the mg setup, shared by ``Solver`` and ``NewmarkSolver``
    (the JAX package's ``install_lam_and_report``): install the per-level
    bounds ``[lam_fine, *coarse_lams]`` into each device tree's ``mg`` (at
    that tree's precision: the float64 tree and the mixed solve's float32
    shadow), warn on a degenerate coarsest Chebyshev interval
    (``validate.check_mg_interval``, a warning and never a failure), emit
    the ``mg_setup`` event (levels, degree, dims, bounds, the interval's
    status, whether the fine bound came from the cache, ``wall_s``: the
    host hierarchy plus the fine bound) and the ``mg.levels`` gauge.
    Returns the float64 bounds."""
    from pcg_mpi_solver_tpu_torch.validate import check_mg_interval

    lam = np.asarray([lam_fine] + list(setup.coarse_lams), np.float64)
    for t in trees:
        t["mg"]["lam"] = lam.astype(t["mg"]["lam"].dtype)
    chk = check_mg_interval(setup.lam_min_coarse,
                            setup.coarse_lams[-1] / MG_LAM_SAFETY)
    if chk.status == "warn":
        warnings.warn(f"[{chk.name}] {chk.detail}")
    recorder.event(
        "mg_setup", levels=int(setup.meta["levels"]),
        degree=int(setup.meta["degree"]),
        dims=list(setup.meta["dims"]),
        lam_fine=round(lam_fine, 6),
        lam_coarse=[round(v, 6) for v in setup.coarse_lams],
        interval=chk.status, cached=bool(cached),
        wall_s=round(wall_s, 6))
    recorder.gauge("mg.levels", int(setup.meta["levels"]))
    return lam
