"""Structured-block slab backend: partition, device data and operator.

Port of ``pcg_mpi_solver_tpu/parallel/structured.py``.  A structured cube
is cut into ``n_parts`` slabs along x; neighbouring slabs share one node
plane, which is owned by the lower slab (owner weight 1) and whose two
copies hold partial sums after the local matvec until ``_halo`` combines
them.  On one device the parts are rows of one ``(P, n_loc)`` tensor, and
the halo is a shift over the part axis — the JAX package's unsharded
multi-part view.  A block of R right-hand sides is ``(R, P, n_loc)``: its
matvec is one kernel launch over the R * P slabs, with the cell scales
repeated once per block width (:func:`block_data`), and its halo
combines planes within each column only.

Local dof layout: component-major ``(c, ix, iy, iz)``, row-major; the
global cell id is x-fastest, so the cell grid is
``model.ck.reshape(nz, ny, nx).transpose(2, 1, 0)``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from pcg_mpi_solver_tpu_torch.models.model_data import ModelData
from pcg_mpi_solver_tpu_torch.ops.matvec import Ops
from pcg_mpi_solver_tpu_torch.ops.precond import corner_block_field
from pcg_mpi_solver_tpu_torch.ops.structured_matvec import (
    CORNERS, gather_cells, scatter_cells, structured_matvec)


@dataclasses.dataclass
class StructuredPartition:
    """Slab decomposition of a structured cube model (host numpy)."""

    n_parts: int
    n_loc: int                  # 3 * nxn_loc * nny * nnz
    n_iface: int                # 0: slab planes combine via _halo
    n_node_loc: int             # nxn_loc * nny * nnz
    glob_n_dof: int
    glob_n_dof_eff: int
    glob_n_node: int
    nxc: int                    # local cells along x (same for every part)
    ny: int
    nz: int

    ck: np.ndarray              # (P, nxc, ny, nz) cell stiffness scale
    ce: np.ndarray              # (P, nxc, ny, nz) cell strain scale (1/h)
    Ke: np.ndarray              # (24, 24)
    diag_Ke: np.ndarray         # (24,)
    Se: np.ndarray              # (6, 24)
    weight: np.ndarray          # (P, n_loc)
    node_weight: np.ndarray     # (P, n_node_loc)
    eff: np.ndarray             # (P, n_loc)
    F: np.ndarray               # (P, n_loc)
    Ud: np.ndarray              # (P, n_loc)
    dof_gid: np.ndarray         # (P, n_loc) int64
    node_gid: np.ndarray        # (P, n_node_loc) int64
    ndof_p: np.ndarray          # (P,)

    # the slab range whose rows are populated ((0, n_parts) for a full build)
    part_range: Optional[tuple] = None


def partition_structured(model: ModelData, n_parts: int,
                         part_range=None) -> StructuredPartition:
    """Slab-partition a structured cube model (requires model.grid set and
    nx % n_parts == 0).  With ``part_range=(lo, hi)`` only those slabs'
    rows are filled; rows outside the range stay zero (-1 for the id
    maps)."""
    if model.grid is None:
        raise ValueError("model has no structured-grid metadata")
    nx, ny, nz, _h = model.grid
    if nx % n_parts != 0:
        raise ValueError(f"nx={nx} not divisible by n_parts={n_parts}")
    if len(model.elem_lib) != 1 or 0 not in model.elem_lib:
        raise ValueError("structured path expects the single-type cube library")

    P = n_parts
    if part_range is None:
        part_range = (0, P)
    lo, hi = int(part_range[0]), int(part_range[1])
    if not (0 <= lo < hi <= P):
        raise ValueError(f"part_range {part_range} outside [0, {P})")
    local = range(lo, hi)
    nxc = nx // P
    nxn = nxc + 1
    nny, nnz = ny + 1, nz + 1
    n_loc = 3 * nxn * nny * nnz

    lib = model.elem_lib[0]

    # cell ck grid: global element id = ex + nx*(ey + ny*ez)  (x fastest)
    ck_glob = np.asarray(model.ck).reshape(nz, ny, nx).transpose(2, 1, 0)
    ck = np.zeros((P, nxc, ny, nz))
    ce = np.zeros((P, nxc, ny, nz))
    ce_glob = np.asarray(model.ce).reshape(nz, ny, nx).transpose(2, 1, 0)
    for p in local:
        ck[p] = ck_glob[p * nxc:(p + 1) * nxc]
        ce[p] = ce_glob[p * nxc:(p + 1) * nxc]

    nnx = nx + 1
    F = np.zeros((P, n_loc))
    Ud = np.zeros((P, n_loc))
    eff = np.zeros((P, n_loc))
    dof_gid = np.full((P, n_loc), -1, dtype=np.int64)

    eff_mask_glob = np.zeros(model.n_dof, dtype=bool)
    eff_mask_glob[model.dof_eff] = True

    n_node_loc = nxn * nny * nnz
    node_gid = np.full((P, n_node_loc), -1, dtype=np.int64)
    IX, IY, IZ = np.meshgrid(np.arange(nxn), np.arange(nny), np.arange(nnz),
                             indexing="ij")
    for p in local:
        gnode = (IX + p * nxc) + nnx * (IY + nny * IZ)          # (nxn,nny,nnz)
        node_gid[p] = gnode.reshape(-1)
        gdof = (3 * gnode[..., None] + np.arange(3)).transpose(3, 0, 1, 2)
        # local flat layout: (c, ix, iy, iz) row-major
        g = gdof.reshape(-1)
        dof_gid[p] = g
        F[p] = model.F[g]
        Ud[p] = model.Ud[g]
        eff[p] = eff_mask_glob[g].astype(float)
    # ownership: a shared plane belongs to the lower slab, so zero the lower
    # plane of every part except the first
    weight = np.ones((P, 3, nxn, nny, nnz))
    weight[1:, :, 0] = 0.0
    weight = weight.reshape(P, n_loc)
    node_weight = np.ones((P, nxn, nny, nnz))
    node_weight[1:, 0] = 0.0
    node_weight = node_weight.reshape(P, n_node_loc)

    return StructuredPartition(
        n_parts=P,
        n_loc=n_loc,
        n_iface=0,
        n_node_loc=n_node_loc,
        glob_n_dof=model.n_dof,
        glob_n_dof_eff=len(model.dof_eff),
        glob_n_node=model.n_node,
        nxc=nxc, ny=ny, nz=nz,
        ck=ck,
        ce=ce,
        Ke=np.asarray(lib["Ke"], np.float64),
        diag_Ke=np.asarray(lib["diagKe"], np.float64),
        Se=np.asarray(lib["Se"], np.float64),
        weight=weight,
        node_weight=node_weight,
        eff=eff,
        F=F,
        Ud=Ud,
        dof_gid=dof_gid,
        node_gid=node_gid,
        ndof_p=np.full(P, n_loc),
        part_range=(lo, hi),
    )


_INT_FIELDS = ("n_parts", "n_loc", "n_iface", "n_node_loc", "glob_n_dof",
               "glob_n_dof_eff", "glob_n_node", "nxc", "ny", "nz")


def partition_from_numpy(arrays: dict) -> StructuredPartition:
    """A partition from the fields of a ``StructuredPartition`` given as a
    dict of numpy arrays and ints — e.g. one built by the JAX package — so
    both packages can run on bit-identical inputs.  Its mg hierarchy
    carries across the same way: ``ops.mg.tree_from_numpy`` takes the
    JAX package's ``MGSetup.tree`` as numpy arrays into the port's device
    tree."""
    names = [f.name for f in dataclasses.fields(StructuredPartition)]
    missing = [n for n in names if n not in arrays and n != "part_range"]
    if missing:
        raise ValueError(f"partition arrays missing fields {missing}")
    kw = {n: (int(arrays[n]) if n in _INT_FIELDS else np.asarray(arrays[n]))
          for n in names if n != "part_range"}
    pr = arrays.get("part_range")
    kw["part_range"] = (0, kw["n_parts"]) if pr is None else tuple(
        int(v) for v in pr)
    sp = StructuredPartition(**kw)
    P, n_loc = sp.n_parts, sp.n_loc
    if n_loc != 3 * (sp.nxc + 1) * (sp.ny + 1) * (sp.nz + 1):
        raise ValueError(f"n_loc={n_loc} does not match the slab grid "
                         f"({sp.nxc}, {sp.ny}, {sp.nz})")
    for n in ("weight", "eff", "F", "Ud", "dof_gid"):
        if getattr(sp, n).shape != (P, n_loc):
            raise ValueError(f"{n} must be {(P, n_loc)}, got "
                             f"{getattr(sp, n).shape}")
    for n in ("ck", "ce"):
        if getattr(sp, n).shape != (P, sp.nxc, sp.ny, sp.nz):
            raise ValueError(f"{n} must be {(P, sp.nxc, sp.ny, sp.nz)}, got "
                             f"{getattr(sp, n).shape}")
    if sp.Ke.shape != (24, 24):
        raise ValueError(f"Ke must be (24, 24), got {sp.Ke.shape}")
    return sp


def device_data_structured(sp: StructuredPartition, dtype: torch.dtype,
                           device) -> dict:
    """The partition's float arrays as contiguous ``dtype`` tensors on
    ``device`` (the tree ``StructuredOps`` and the PCG loop read)."""
    def put(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype,
                               device=device).contiguous()

    return {
        "blocks": [{
            "Ke": put(sp.Ke),
            "diag_Ke": put(sp.diag_Ke),
            "Se": put(sp.Se),
            "ck": put(sp.ck),
            "ce": put(sp.ce),
        }],
        "weight": put(sp.weight),
        "node_weight": put(sp.node_weight),
        "eff": put(sp.eff),
        "F": put(sp.F),
        "Ud": put(sp.Ud),
    }


def block_data(data: dict, R: int) -> dict:
    """The device tree for blocks of ``R`` right-hand sides: ``data`` with
    its cell scales repeated once per column (``ck_rows``, (R * P, nx,
    ny, nz), column-major over the parts: row r * P + p is part p), so
    that a blocked matvec launches the kernel once over the R * P slabs.
    Built once per block width (R x 13.5 MB in float32 and 27 MB in
    float64 at 150^3); every other leaf is shared with ``data``."""
    blk = data["blocks"][0]
    ck = blk["ck"]
    rows = ck if R == 1 else ck.repeat(R, 1, 1, 1)
    return dict(data, blocks=[dict(blk, ck_rows=rows)])


@dataclasses.dataclass(frozen=True)
class StructuredOps(Ops):
    """The operator protocol on slab-structured parts.  ``variant`` and
    ``planes`` name the kernel its float32 matvecs launch on the card
    (``ops.structured_matvec.structured_matvec``); float64 matvecs take
    v6's double kernel whatever they say."""

    nxc: int = 0
    ny: int = 0
    nz: int = 0
    variant: str = "v6"
    planes: Optional[int] = None

    @classmethod
    def from_partition(cls, sp: StructuredPartition,
                       dot_dtype: torch.dtype = torch.float64,
                       variant: str = "v6", planes: Optional[int] = None,
                       mg_degree: int = 2):
        return cls(n_loc=sp.n_loc, n_iface=0,
                   n_node_loc=sp.n_node_loc, n_node_iface=0,
                   dot_dtype=dot_dtype, mg_degree=mg_degree,
                   nxc=sp.nxc, ny=sp.ny, nz=sp.nz, n_parts=sp.n_parts,
                   variant=variant, planes=planes)

    def block_data(self, data: dict, R: int) -> dict:
        return block_data(data, R)

    def _grid(self, x: torch.Tensor) -> torch.Tensor:
        """([R,] P, n_loc) -> ([R,] P, 3, nx+1, ny+1, nz+1)."""
        return x.reshape(*x.shape[:-1], 3, self.nxc + 1, self.ny + 1,
                         self.nz + 1)

    def _halo(self, yg: torch.Tensor) -> torch.Tensor:
        """Combine partial sums on shared slab-boundary planes: part p's
        last plane adds into part p+1's first and vice versa.  ``yg`` is
        ([R,] P, C, nx+1, ny+1, nz+1); the exchange runs along the part
        axis of each column alone."""
        if self.n_parts == 1:
            return yg
        up = yg[..., -1, :, :]           # (..., P, C, ny+1, nz+1)
        dn = yg[..., 0, :, :]
        zero = torch.zeros_like(up.narrow(-4, 0, 1))
        from_left = torch.cat([zero, up.narrow(-4, 0, self.n_parts - 1)],
                              dim=-4)
        from_right = torch.cat([dn.narrow(-4, 1, self.n_parts - 1), zero],
                               dim=-4)
        yg = yg.clone()
        yg[..., 0, :, :] += from_left
        yg[..., -1, :, :] += from_right
        return yg

    def matvec_local(self, data: dict, x: torch.Tensor) -> torch.Tensor:
        """Per-part K.x without the halo.  A block (R, P, n_loc) is ONE
        kernel launch over its R * P slabs, on the cell scales that
        :func:`block_data` repeated for that width."""
        blk = data["blocks"][0]
        ck = blk["ck"] if x.dim() == 2 else blk.get("ck_rows", blk["ck"])
        xg = x.reshape(-1, 3, self.nxc + 1, self.ny + 1, self.nz + 1)
        if ck.shape[0] != xg.shape[0]:
            raise ValueError(
                f"a block of {x.shape[0]} right-hand sides needs the "
                f"device tree of block_data(data, {x.shape[0]})")
        y = structured_matvec(xg, ck, blk["Ke"], variant=self.variant,
                              planes=self.planes)
        return y.reshape(x.shape)

    def matvec(self, data: dict, x: torch.Tensor) -> torch.Tensor:
        yg = self._grid(self.matvec_local(data, x))
        return self._halo(yg).reshape(x.shape)

    def diag_local(self, data: dict) -> torch.Tensor:
        blk = data["blocks"][0]
        v = blk["diag_Ke"][None, :, None, None, None] * blk["ck"][:, None]
        return scatter_cells(v).reshape(v.shape[0], self.n_loc)

    def diag(self, data: dict) -> torch.Tensor:
        yg = self._grid(self.diag_local(data))
        return self._halo(yg).reshape(-1, self.n_loc)

    # -- node-block (3x3) diagonal for block-Jacobi ---------------------
    def node_block_diag(self, data: dict) -> torch.Tensor:
        """Per-node 3x3 blocks (P, n_node_loc, 3, 3), assembled as 9
        channels on the node grid (``corner_block_field``); slab-boundary
        planes combine through the halo like any other field."""
        blk = data["blocks"][0]
        ck = blk["ck"]
        P = ck.shape[0]
        g = self._halo(corner_block_field(blk["Ke"], ck, CORNERS))
        return g.reshape(P, 9, self.n_node_loc).transpose(1, 2) \
            .reshape(P, self.n_node_loc, 3, 3)

    # -- export path ----------------------------------------------------
    def elem_strain(self, data: dict, x: torch.Tensor) -> list:
        """Cell strains eps = Se.(ce * u_cell), one (P, 6, cells) tensor,
        cells in (x, y, z) row-major order of the part's slab."""
        blk = data["blocks"][0]
        u = gather_cells(self._grid(x))                    # (P, 24, cells)
        eps = torch.einsum("sd,pdxyz->psxyz", blk["Se"],
                           blk["ce"][:, None] * u)
        return [eps.reshape(eps.shape[0], 6, -1)]

    def elem_scale(self, data: dict) -> list:
        blk = data["blocks"][0]
        return [(blk["ck"] * blk["ce"]).reshape(blk["ck"].shape[0], -1)]

    def nodal_average(self, data: dict, vals_list) -> torch.Tensor:
        """Cell values -> averaged nodal grid (P, k, n_node_loc): sums and
        counts as the eight zero-padded corner translates, added in corner
        order, the slab planes combined by the halo as extra channels."""
        vals = vals_list[0]
        P, k = vals.shape[0], vals.shape[1]
        vg = vals.reshape(P, k, self.nxc, self.ny, self.nz)
        both = torch.cat([vg, torch.ones_like(vg[:, :1])], dim=1)
        y = None
        for dx, dy, dz in CORNERS:
            t = torch.nn.functional.pad(both, (dz, 1 - dz, dy, 1 - dy,
                                               dx, 1 - dx))
            y = t if y is None else y + t
        y = self._halo(y)
        avg = y[:, :k] / (y[:, k:] + 1e-15)
        return avg.reshape(P, k, -1)

    def _as_node3(self, v: torch.Tensor) -> torch.Tensor:
        # the structured dof layout is component-major: ([R,] P, 3, nodes)
        return v.reshape(*v.shape[:-1], 3, self.n_node_loc).transpose(-1,
                                                                       -2)

    def _from_node3(self, z3: torch.Tensor) -> torch.Tensor:
        return z3.transpose(-1, -2).reshape(*z3.shape[:-2], self.n_loc)
