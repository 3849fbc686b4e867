"""Reader/writer for the reference's Model Definition Files (MDF) bundle.

A user of the reference brings models as a zip of binary arrays + .mat files
(produced by its offline MATLAB meshing pipeline).  Schema, with reference
citations:

- ``GlobN.mat`` Data[0..8] = [NElem, NDof, NDofGlbFlat, NNodeGlbFlat,
  NDofEff, NFacesFlat, NFaces, NPolysFlat, NFixedDof] (run_metis.py:19-34)
- per-element CSR-ish arrays with INCLUSIVE [start, end] offset pairs
  (partition_mesh.py:172-175, slices ``flat[o[i,0]:o[i,1]+1]`` :246-254):
  ``NodeGlbFlat.bin`` int32 + ``NodeGlbOffset.bin`` int64 (N,2) F-order;
  ``DofGlbFlat``/``DofGlbOffset``; ``SignFlat`` int8 + ``SignOffset``;
  ``Type`` int32, ``Level/Ck/Cm/Ce`` f64, ``PolyMat`` int32,
  ``sctrs`` f64 (N,3) F-order, ``StrsGlb``/``StrsSign`` int8 (N,6)
- nodal arrays (partition_mesh.py:324-330): ``DiagM/F/Ud/Vd/NodeCoordVec``
  f64 (NDof,) — NodeCoordVec holds each dof's node coordinate for that
  dof's axis (x for dof 3n, y for 3n+1, z for 3n+2; interleaved ravel of
  node coords, see identify_PotentialNeighbours partition_mesh.py:688-690);
  ``DofEff``/``FixedDof`` int32 id lists
- element library ``Ke.mat``/``Me.mat`` Data = per-type dense matrices
  (partition_mesh.py:543-547); ``MatProp.mat`` struct array E/Pos/Rho
  (partition_mesh.py:503-512); ``dt.mat`` scalar
- visualization topology: ``nodes.bin`` f64 (NNode,3), ``FacesFlat.bin``
  int32 + ``FacesOffset.bin`` int64 (NFaces,2), ``PolysFlat.bin`` int32
  (export_vtk.py:55-70,108-112)
- ``Intfc.npz`` (OUR schema extension, absent from the reference): cohesive
  interface elements — the reference keeps these only inside its partition
  pickles (partition_mesh.py:603-650), so they have no MDF representation
  to mirror
- ``Grid.npz`` / ``Octree.npz`` (OUR schema extensions): structured-grid /
  octree-lattice fast-path metadata (ModelData.grid / .octree), so a
  re-ingested model keeps its structured/hybrid backend eligibility;
  readers of the reference schema can ignore both

The writer emits the same schema from a ModelData (round-trip tested), so
synthetic models can feed the reference and vice versa.

The JAX package's ``models/mdf.py`` (its copy here: a bundle either writes
reads back in the other, field for field), with the streamed slab ingest
of the multi-process build (:func:`slab_elem_ids`, :func:`read_mdf_slab`:
one process's slab as a ``ModelData`` view over memmapped arrays).
"""

from __future__ import annotations

import dataclasses
import os
import shutil
from typing import Optional

import numpy as np
import scipy.io

from pcg_mpi_solver_tpu_torch.models.model_data import ModelData, SparseVec


def _offsets_to_csr(flat, offset2):
    """Inclusive [start,end] pairs -> (contiguous flat, n+1 exclusive offsets)."""
    starts = offset2[:, 0]
    ends = offset2[:, 1] + 1
    lens = ends - starts
    csr_offset = np.concatenate([[0], np.cumsum(lens)])
    # re-pack (slices may in principle be non-contiguous in the source)
    if np.array_equal(starts, csr_offset[:-1]):
        packed = flat[: csr_offset[-1]]
    else:
        packed = np.concatenate([flat[s:e] for s, e in zip(starts, ends)])
    return packed, csr_offset


def _csr_to_offsets(offset):
    """n+1 exclusive offsets -> inclusive [start, end] int64 pairs."""
    return np.stack([offset[:-1], offset[1:] - 1], axis=1).astype(np.int64)


def read_mdf(mdf_path: str) -> ModelData:
    p = lambda name: os.path.join(mdf_path, name)
    glob_n = scipy.io.loadmat(p("GlobN.mat"))["Data"][0]
    n_elem = int(glob_n[0])
    n_dof = int(glob_n[1])
    n_node = n_dof // 3
    n_dof_flat = int(glob_n[2])
    n_node_flat = int(glob_n[3])
    n_dof_eff = int(glob_n[4])
    n_fixed = int(glob_n[8])

    def bin_(name, dtype, shape=None, order="C"):
        a = np.fromfile(p(name + ".bin"), dtype=dtype)
        if shape is not None:
            a = a.reshape(shape, order=order)
        return a

    node_flat = bin_("NodeGlbFlat", np.int32)[:n_node_flat].astype(np.int64)
    node_off2 = bin_("NodeGlbOffset", np.int64, (n_elem, 2), "F")
    dof_flat = bin_("DofGlbFlat", np.int32)[:n_dof_flat].astype(np.int64)
    dof_off2 = bin_("DofGlbOffset", np.int64, (n_elem, 2), "F")
    sign_flat = bin_("SignFlat", np.int8)[:n_dof_flat].astype(bool)
    sign_off2 = bin_("SignOffset", np.int64, (n_elem, 2), "F")

    nodes_flat, nodes_offset = _offsets_to_csr(node_flat, node_off2)
    dofs_flat, dofs_offset = _offsets_to_csr(dof_flat, dof_off2)
    signs_flat, signs_offset = _offsets_to_csr(sign_flat, sign_off2)
    if not np.array_equal(signs_offset, dofs_offset):
        raise ValueError("SignOffset inconsistent with DofGlbOffset")

    elem_type = bin_("Type", np.int32)[:n_elem]
    level = bin_("Level", np.float64)[:n_elem]
    ck = bin_("Ck", np.float64)[:n_elem]
    cm = bin_("Cm", np.float64)[:n_elem]
    ce = bin_("Ce", np.float64)[:n_elem]
    poly_mat = bin_("PolyMat", np.int32)[:n_elem]
    sctrs = bin_("sctrs", np.float64, (n_elem, 3), "F")

    diag_m = bin_("DiagM", np.float64)[:n_dof]
    F = bin_("F", np.float64)[:n_dof]
    Ud = bin_("Ud", np.float64)[:n_dof]
    Vd = bin_("Vd", np.float64)[:n_dof]
    dof_eff = bin_("DofEff", np.int32)[:n_dof_eff].astype(np.int64)
    fixed_dof = bin_("FixedDof", np.int32)[:n_fixed].astype(np.int64)

    if os.path.exists(p("nodes.bin")):
        # column-major on disk: the reference reads (NNode, 3) with
        # order='F' (export_vtk.py:70 via loadBinDataInSharedMem)
        raw_nodes = bin_("nodes", np.float64)
        node_coords = raw_nodes.reshape((n_node, 3), order="F")
        if os.path.exists(p("NodeCoordVec.bin")):
            # NodeCoordVec is dof-interleaved (= C-order ravel of the
            # coords) in both layouts — use it to detect legacy bundles
            # written row-major by pre-fix write_mdf, instead of silently
            # scrambling their geometry.
            ncv = bin_("NodeCoordVec", np.float64)[:n_dof]
            if not np.array_equal(node_coords.ravel(), ncv):
                legacy = raw_nodes.reshape(n_node, 3)
                if np.array_equal(legacy.ravel(), ncv):
                    node_coords = legacy
                else:
                    raise ValueError(
                        "nodes.bin matches neither the reference's "
                        "column-major layout nor the legacy row-major "
                        "layout (cross-checked against NodeCoordVec.bin)")
    else:
        node_coords = bin_("NodeCoordVec", np.float64)[:n_dof].reshape(n_node, 3)

    # element library
    Ke = scipy.io.loadmat(p("Ke.mat"))["Data"][0]
    Me = scipy.io.loadmat(p("Me.mat"))["Data"][0] if os.path.exists(p("Me.mat")) else None
    Se = scipy.io.loadmat(p("Se.mat"))["Data"][0] if os.path.exists(p("Se.mat")) else None
    elem_lib = {}
    for t in range(len(Ke)):
        Ket = np.asarray(Ke[t], float)
        elem_lib[t] = {
            "Ke": Ket,
            "diagKe": np.diag(Ket).copy(),
            "Me": np.asarray(Me[t], float) if Me is not None else None,
            "Se": np.asarray(Se[t], float) if Se is not None else None,
            "n_nodes": Ket.shape[0] // 3,
        }

    mat_raw = scipy.io.loadmat(p("MatProp.mat"), struct_as_record=False)["Data"][0]
    mat_prop = []
    for m in mat_raw:
        d = m.__dict__
        entry = {"E": float(d["E"][0][0]), "Pos": float(d["Pos"][0][0]),
                 "Rho": float(d["Rho"][0][0])}
        if "NonLocStressParam" in d:
            # alternating [key, value, ...] cell array, exactly the layout the
            # reference parses (partition_mesh.py:515-520)
            raw = d["NonLocStressParam"][0]
            nl = {str(raw[2 * i][0]): float(raw[2 * i + 1][0][0])
                  for i in range(len(raw) // 2)}
            if nl:
                entry["NonLocStressParam"] = nl
        mat_prop.append(entry)

    dt = float(scipy.io.loadmat(p("dt.mat"))["Data"][0][0]) \
        if os.path.exists(p("dt.mat")) else 1.0

    faces_flat = faces_offset = None
    if os.path.exists(p("FacesFlat.bin")):
        n_faces = int(glob_n[6])
        ff = bin_("FacesFlat", np.int32)[: int(glob_n[5])].astype(np.int64)
        fo2 = bin_("FacesOffset", np.int64, (n_faces, 2), "F")
        faces_flat, faces_offset = _offsets_to_csr(ff, fo2)

    # fast-path metadata sidecars (not part of the reference schema;
    # re-ingested models keep their structured/hybrid backend eligibility)
    grid = None
    octree = None
    if os.path.exists(p("Grid.npz")):
        with np.load(p("Grid.npz")) as z:
            grid = (int(z["nx"]), int(z["ny"]), int(z["nz"]),
                    float(z["h"]))
    if os.path.exists(p("Octree.npz")):
        with np.load(p("Octree.npz")) as z:
            octree = {
                "leaves": z["leaves"],
                "dims": tuple(int(d) for d in z["dims"]),
                "node_keys": z["node_keys"],
                "strides": tuple(int(s) for s in z["strides"]),
                "brick_type": (int(z["brick_type"])
                               if int(z["brick_type"]) >= 0 else None),
                "brick_corners": (z["brick_corners"]
                                  if z["brick_corners"].size else None),
            }

    intfc_elems = None
    if os.path.exists(p("Intfc.npz")):
        with np.load(p("Intfc.npz")) as z:
            # bind each member once: NpzFile re-reads the whole array per access
            nid, adj = z["node_id_list"], z["adj_elem"]
            kn, kt, area, nax = z["kn"], z["kt"], z["area"], z["normal_axis"]
        intfc_elems = [
            {"NodeIdList": nid[i], "adj_elem": int(adj[i]),
             "kn": float(kn[i]), "kt": float(kt[i]),
             "area": float(area[i]), "normal_axis": int(nax[i])}
            for i in range(len(adj))
        ]

    md = ModelData(
        n_elem=n_elem, n_node=n_node, n_dof=n_dof,
        node_coords=node_coords, F=F, Ud=Ud, Vd=Vd, diag_M=diag_m,
        fixed_dof=fixed_dof, dof_eff=dof_eff,
        elem_type=elem_type,
        elem_nodes_flat=nodes_flat, elem_nodes_offset=nodes_offset,
        elem_dofs_flat=dofs_flat, elem_dofs_offset=dofs_offset,
        elem_sign_flat=signs_flat,
        ck=ck, cm=cm, ce=ce, level=level, poly_mat=poly_mat, sctrs=sctrs,
        elem_lib=elem_lib, mat_prop=mat_prop, dt=dt,
        faces_flat=faces_flat, faces_offset=faces_offset,
        grid=grid, octree=octree,
        intfc_elems=intfc_elems,
    )
    # grid-only bundles skip the rebuild: backend selection picks
    # 'structured' anyway, so the multi-pass geometry scan buys nothing
    if (octree is None and grid is None
            and os.environ.get("PCG_TPU_RECONSTRUCT", "1") == "1"):
        # A GENUINE reference bundle has no fast-path sidecars (they are
        # our schema extension); rebuild the octree-lattice metadata from
        # the schema's own geometry so it routes to the hybrid backend
        # (reconstruct_lattice_meta engages only on exact lattice fits).
        from pcg_mpi_solver_tpu_torch.models.octree import reconstruct_lattice_meta

        reconstruct_lattice_meta(md)
    return md


def write_mdf(model: ModelData, mdf_path: str) -> str:
    """Write a ModelData in the reference's MDF schema."""
    if model.n_dof != 3 * model.n_node:
        # The MDF schema is the reference's 3-dof elasticity format
        # (NodeCoordVec etc. interleave 3 components per node,
        # partition_mesh.py:172-175) — it cannot carry the scalar class.
        raise ValueError(
            "the MDF schema is 3-dof-per-node (reference elasticity "
            "format); scalar (Poisson) models cannot be written — keep "
            "them as in-memory/synthetic models")
    os.makedirs(mdf_path, exist_ok=True)
    p = lambda name: os.path.join(mdf_path, name)

    n_faces = 0 if model.faces_offset is None else len(model.faces_offset) - 1
    n_faces_flat = 0 if model.faces_flat is None else len(model.faces_flat)
    glob_n = np.array([
        model.n_elem, model.n_dof, len(model.elem_dofs_flat),
        len(model.elem_nodes_flat), len(model.dof_eff), n_faces_flat,
        n_faces, n_faces, len(model.fixed_dof),
    ], dtype=np.float64)
    scipy.io.savemat(p("GlobN.mat"), {"Data": glob_n})
    scipy.io.savemat(p("dt.mat"), {"Data": np.array([model.dt])})

    model.elem_nodes_flat.astype(np.int32).tofile(p("NodeGlbFlat.bin"))
    _csr_to_offsets(model.elem_nodes_offset).ravel(order="F").tofile(p("NodeGlbOffset.bin"))
    model.elem_dofs_flat.astype(np.int32).tofile(p("DofGlbFlat.bin"))
    _csr_to_offsets(model.elem_dofs_offset).ravel(order="F").tofile(p("DofGlbOffset.bin"))
    model.elem_sign_flat.astype(np.int8).tofile(p("SignFlat.bin"))
    _csr_to_offsets(model.elem_dofs_offset).ravel(order="F").tofile(p("SignOffset.bin"))

    model.elem_type.astype(np.int32).tofile(p("Type.bin"))
    model.level.astype(np.float64).tofile(p("Level.bin"))
    model.ck.astype(np.float64).tofile(p("Ck.bin"))
    model.cm.astype(np.float64).tofile(p("Cm.bin"))
    model.ce.astype(np.float64).tofile(p("Ce.bin"))
    model.poly_mat.astype(np.int32).tofile(p("PolyMat.bin"))
    np.asfortranarray(model.sctrs).ravel(order="F").tofile(p("sctrs.bin"))
    np.zeros((model.n_elem, 6), np.int8).ravel(order="F").tofile(p("StrsGlb.bin"))
    np.zeros((model.n_elem, 6), np.int8).ravel(order="F").tofile(p("StrsSign.bin"))

    model.diag_M.astype(np.float64).tofile(p("DiagM.bin"))
    model.F.astype(np.float64).tofile(p("F.bin"))
    model.Ud.astype(np.float64).tofile(p("Ud.bin"))
    model.Vd.astype(np.float64).tofile(p("Vd.bin"))
    model.node_coords.astype(np.float64).ravel().tofile(p("NodeCoordVec.bin"))
    model.dof_eff.astype(np.int32).tofile(p("DofEff.bin"))
    model.fixed_dof.astype(np.int32).tofile(p("FixedDof.bin"))
    # column-major to match the reference's order='F' read (see read_mdf)
    model.node_coords.astype(np.float64).ravel(order="F").tofile(
        p("nodes.bin"))

    type_ids = sorted(model.elem_lib.keys())
    ke_arr = np.empty(len(type_ids), dtype=object)
    me_arr = np.empty(len(type_ids), dtype=object)
    se_arr = np.empty(len(type_ids), dtype=object)
    for i, t in enumerate(type_ids):
        lib = model.elem_lib[t]
        ke_arr[i] = np.asarray(lib["Ke"], float)
        me_arr[i] = np.asarray(lib["Me"] if lib.get("Me") is not None
                               else np.zeros_like(lib["Ke"]), float)
        se_arr[i] = np.asarray(lib["Se"] if lib.get("Se") is not None
                               else np.zeros((6, lib["Ke"].shape[0])), float)
    scipy.io.savemat(p("Ke.mat"), {"Data": ke_arr.reshape(1, -1)})
    scipy.io.savemat(p("Me.mat"), {"Data": me_arr.reshape(1, -1)})
    scipy.io.savemat(p("Se.mat"), {"Data": se_arr.reshape(1, -1)})

    dtype = [("E", object), ("Pos", object), ("Rho", object),
             ("NonLocStressParam", object)]
    rec = np.zeros((1, len(model.mat_prop)), dtype=dtype)
    for i, m in enumerate(model.mat_prop):
        nl = m.get("NonLocStressParam", {})
        nl_arr = np.empty((1, 2 * len(nl)), dtype=object)
        for j, (key, val) in enumerate(nl.items()):
            nl_arr[0, 2 * j] = np.array([key])
            nl_arr[0, 2 * j + 1] = np.array([[val]])
        rec[0, i] = (np.array([[m["E"]]]), np.array([[m["Pos"]]]),
                     np.array([[m["Rho"]]]), nl_arr)
    scipy.io.savemat(p("MatProp.mat"), {"Data": rec})

    if model.faces_flat is not None:
        model.faces_flat.astype(np.int32).tofile(p("FacesFlat.bin"))
        _csr_to_offsets(model.faces_offset).ravel(order="F").tofile(p("FacesOffset.bin"))
        # PolysFlat carries face-id incidence: the reference's Boundary mode
        # keeps ids with bincount == 1 (export_vtk.py:112).  Our face list
        # stores interior faces TWICE (one record per adjacent cell), so we
        # emit each record's CANONICAL id (first record with the same node
        # set): canonical interior ids then count 2, their duplicates 0,
        # boundary ids 1 — exactly the reference's semantics.  For models
        # that store only boundary faces this reduces to arange.
        from pcg_mpi_solver_tpu_torch.vtk.export import _face_table

        canon = np.arange(n_faces, dtype=np.int64)
        for idx, arr in _face_table(model.faces_flat, model.faces_offset):
            key = np.sort(arr, axis=1)
            _, first, inv = np.unique(key, axis=0, return_index=True,
                                      return_inverse=True)
            canon[idx] = idx[first[inv]]
        canon.astype(np.int32).tofile(p("PolysFlat.bin"))

    for name, present in (("Grid.npz", model.grid is not None),
                          ("Octree.npz", model.octree is not None)):
        if not present and os.path.exists(p(name)):
            os.remove(p(name))      # never leave stale sidecars behind
    if model.grid is not None:
        nx_, ny_, nz_, h_ = model.grid
        np.savez(p("Grid.npz"), nx=nx_, ny=ny_, nz=nz_, h=h_)
    if model.octree is not None:
        ot = model.octree
        bt = ot.get("brick_type")
        bc = ot.get("brick_corners")
        np.savez(
            p("Octree.npz"),
            leaves=np.asarray(ot["leaves"], np.int64),
            dims=np.asarray(ot["dims"], np.int64),
            node_keys=np.asarray(ot["node_keys"], np.int64),
            strides=np.asarray(ot["strides"], np.int64),
            brick_type=np.int64(-1 if bt is None else bt),
            brick_corners=(np.zeros((0, 3), np.int64) if bc is None
                           else np.asarray(bc, np.int64)),
        )

    if not model.intfc_elems and os.path.exists(p("Intfc.npz")):
        os.remove(p("Intfc.npz"))   # never leave stale interfaces behind
    if model.intfc_elems:
        ie = model.intfc_elems
        np.savez(
            p("Intfc.npz"),
            node_id_list=np.stack([np.asarray(e["NodeIdList"]) for e in ie]),
            adj_elem=np.array([e["adj_elem"] for e in ie], dtype=np.int64),
            kn=np.array([e["kn"] for e in ie]),
            kt=np.array([e["kt"] for e in ie]),
            area=np.array([e["area"] for e in ie]),
            normal_axis=np.array([e["normal_axis"] for e in ie], dtype=np.int32),
        )
    return mdf_path


# ----------------------------------------------------------------------
# Ingest accounting and the streamed slab ingest's entry points
# ----------------------------------------------------------------------

@dataclasses.dataclass
class IngestStats:
    """Peak-host-memory accounting of one streamed ingest: ``retained``
    bytes live in the returned model, ``transient`` bytes existed only
    during a chunked pass.  ``peak_bytes`` is the asserted bound in
    tests and the ``ingest_peak_bytes`` field of the setup-ladder
    artifact."""

    retained_bytes: int = 0
    peak_bytes: int = 0
    _transient: int = 0

    def retain(self, *arrays) -> None:
        for a in arrays:
            if a is not None:
                self.retained_bytes += int(np.asarray(a).nbytes)
        self._bump()

    def transient(self, nbytes: int) -> None:
        self._transient = int(nbytes)
        self._bump()
        self._transient = 0

    def _bump(self) -> None:
        self.peak_bytes = max(self.peak_bytes,
                              self.retained_bytes + self._transient)


def _mm(path, dtype, shape=None, order="C"):
    """Read-only memmap of one MDF .bin array: fancy-indexed gathers
    touch only the selected pages — the mechanism that keeps slab
    ingest's peak memory at slab size."""
    mm = np.memmap(path, dtype=dtype, mode="r")
    if shape is not None:
        mm = mm[: int(np.prod(shape))].reshape(shape, order=order)
    return mm


def slab_elem_ids(mdf_path: str, slab_idx: int, n_slabs: int,
                  chunk_elems: int = 250_000,
                  stats: Optional[IngestStats] = None) -> np.ndarray:
    """Element ids of one coarse slab: the SAME cut as
    ``parallel/partition.coarse_slab_cut`` (dominant centroid axis,
    stable sort, balanced contiguous chunks), with the axis extents
    found by a CHUNKED pass over ``sctrs`` so full coordinates are never
    materialized.  The one O(n_elem) transient is the chosen axis's
    scalar column (the sort key).  Returns SORTED ascending global ids
    (gather locality)."""
    glob_n = scipy.io.loadmat(os.path.join(mdf_path, "GlobN.mat"))["Data"][0]
    n_elem = int(glob_n[0])
    if not (0 <= slab_idx < n_slabs):
        raise ValueError(f"slab_idx {slab_idx} outside [0, {n_slabs})")
    if n_slabs == 1:
        return np.arange(n_elem, dtype=np.int64)
    # sctrs is F-order (n_elem, 3): each axis is one contiguous column
    sc = _mm(os.path.join(mdf_path, "sctrs.bin"), np.float64,
             (n_elem, 3), "F")
    ext = np.zeros(3)
    for a in range(3):
        amin, amax = np.inf, -np.inf
        for i in range(0, n_elem, chunk_elems):
            col = np.asarray(sc[i:i + chunk_elems, a])
            if stats is not None:
                stats.transient(col.nbytes)
            amin = min(amin, float(col.min()))
            amax = max(amax, float(col.max()))
        ext[a] = amax - amin
    axis = int(np.argmax(ext))
    coord = np.asarray(sc[:, axis])          # ONE scalar column, transient
    if stats is not None:
        stats.transient(coord.nbytes)
    order = np.argsort(coord, kind="stable")
    if stats is not None:
        stats.transient(coord.nbytes + order.nbytes)
    lo = int(round(n_elem * slab_idx / n_slabs))
    hi = int(round(n_elem * (slab_idx + 1) / n_slabs))
    return np.sort(order[lo:hi]).astype(np.int64)


def read_mdf_slab(mdf_path: str, slab_idx: int, n_slabs: int,
                  chunk_elems: int = 250_000,
                  stats: Optional[IngestStats] = None) -> ModelData:
    """Streamed slab ingest of an MDF bundle: a ModelData VIEW holding
    only slab ``slab_idx`` of ``n_slabs`` — per-element arrays cover the
    slab's elements (``elem_ids`` maps to global ids, ``n_elem`` is the
    slab count), nodal arrays are :class:`SparseVec` restrictions to the
    dofs/nodes the slab references.  Global counts/ids are untouched, so
    ``partition_model(part_range=..., comm=...)`` consumes the view
    directly (elem_part slab-positional) and the interface reduction
    still runs on global ids.  Bundles with cohesive interface elements
    or octree sidecars need the full reader (their structures are not
    slab-separable); ``Grid.npz`` passes through.

    Peak host memory: O(slab + chunk) for connectivity/coordinates (the
    asserted bound — ``stats.peak_bytes``), plus three O(n) transients:
    the coarse-cut sort key, its argsort, and the effective-dof id list
    it intersects."""
    stats = stats if stats is not None else IngestStats()
    p = lambda name: os.path.join(mdf_path, name)
    if os.path.exists(p("Intfc.npz")):
        raise NotImplementedError(
            "read_mdf_slab: cohesive interface elements are not "
            "slab-separable (their anchor elements cross slabs); use "
            "read_mdf")
    if os.path.exists(p("Octree.npz")):
        raise NotImplementedError(
            "read_mdf_slab: octree-lattice models route to the hybrid "
            "backend, which needs the full model; use read_mdf")
    glob_n = scipy.io.loadmat(p("GlobN.mat"))["Data"][0]
    n_elem = int(glob_n[0])
    n_dof = int(glob_n[1])
    n_node = n_dof // 3
    n_dof_flat = int(glob_n[2])
    n_node_flat = int(glob_n[3])
    n_dof_eff = int(glob_n[4])
    n_fixed = int(glob_n[8])

    e = slab_elem_ids(mdf_path, slab_idx, n_slabs, chunk_elems, stats)
    ne = len(e)

    # ---- per-element scalars (memmap row gathers) ---------------------
    elem_type = np.asarray(_mm(p("Type.bin"), np.int32)[:n_elem][e])
    level = np.asarray(_mm(p("Level.bin"), np.float64)[:n_elem][e])
    ck = np.asarray(_mm(p("Ck.bin"), np.float64)[:n_elem][e])
    cm = np.asarray(_mm(p("Cm.bin"), np.float64)[:n_elem][e])
    ce = np.asarray(_mm(p("Ce.bin"), np.float64)[:n_elem][e])
    poly_mat = np.asarray(_mm(p("PolyMat.bin"), np.int32)[:n_elem][e])
    sctrs = np.asarray(_mm(p("sctrs.bin"), np.float64,
                           (n_elem, 3), "F")[e])
    stats.retain(elem_type, level, ck, cm, ce, poly_mat, sctrs, e)

    # ---- slab CSR connectivity (chunked ragged gather) ----------------
    def slab_csr(flat_name, off_name, dtype, n_flat):
        off2 = _mm(p(off_name), np.int64, (n_elem, 2), "F")
        starts = np.asarray(off2[e, 0])
        ends = np.asarray(off2[e, 1]) + 1
        lens = ends - starts
        offset = np.concatenate([[0], np.cumsum(lens)])
        flat_mm = _mm(p(flat_name), dtype)
        out = np.empty(int(offset[-1]), dtype=dtype)
        for i in range(0, ne, chunk_elems):
            j = min(i + chunk_elems, ne)
            idx = _ragged_index(starts[i:j], lens[i:j])
            stats.transient(idx.nbytes)
            out[offset[i]:offset[j]] = flat_mm[idx]
        return out, offset

    nodes_flat_raw, nodes_offset = slab_csr(
        "NodeGlbFlat.bin", "NodeGlbOffset.bin", np.int32, n_node_flat)
    dofs_flat_raw, dofs_offset = slab_csr(
        "DofGlbFlat.bin", "DofGlbOffset.bin", np.int32, n_dof_flat)
    signs_flat, signs_offset = slab_csr(
        "SignFlat.bin", "SignOffset.bin", np.int8, n_dof_flat)
    if not np.array_equal(signs_offset, dofs_offset):
        raise ValueError("SignOffset inconsistent with DofGlbOffset")
    nodes_flat = nodes_flat_raw.astype(np.int64)
    dofs_flat = dofs_flat_raw.astype(np.int64)
    stats.retain(nodes_flat, nodes_offset, dofs_flat, dofs_offset,
                 signs_flat)

    # ---- referenced nodal entries (sparse restriction) ----------------
    ref_dofs = np.unique(dofs_flat)
    ref_nodes = np.unique(nodes_flat)

    def sparse(name, ids):
        mm = _mm(p(name + ".bin"), np.float64)
        vals = np.asarray(mm[:n_dof][ids])
        stats.retain(vals)
        return SparseVec(ids, vals, n_dof, strict=False)

    F = sparse("F", ref_dofs)
    Ud = sparse("Ud", ref_dofs)
    Vd = sparse("Vd", ref_dofs)
    diag_m = sparse("DiagM", ref_dofs)
    if os.path.exists(p("nodes.bin")):
        nc = _mm(p("nodes.bin"), np.float64, (n_node, 3), "F")
        nc_vals = np.asarray(nc[ref_nodes])
        if os.path.exists(p("NodeCoordVec.bin")):
            # same legacy-layout cross-check as read_mdf, on the slab's
            # rows only: NodeCoordVec is the C-order ravel of the
            # coords in BOTH layouts — a pre-fix row-major nodes.bin
            # must be detected, not silently transposed
            ncv = _mm(p("NodeCoordVec.bin"), np.float64)
            ref = np.asarray(ncv[(3 * ref_nodes[:, None]
                                  + np.arange(3)).ravel()]).reshape(-1, 3)
            if not np.array_equal(nc_vals, ref):
                legacy = np.asarray(
                    _mm(p("nodes.bin"), np.float64,
                        (n_node, 3))[ref_nodes])
                if np.array_equal(legacy, ref):
                    nc_vals = legacy
                else:
                    raise ValueError(
                        "nodes.bin matches neither the reference's "
                        "column-major layout nor the legacy row-major "
                        "layout (cross-checked against "
                        "NodeCoordVec.bin on the slab's nodes)")
    else:
        nc = _mm(p("NodeCoordVec.bin"), np.float64).reshape(n_node, 3)
        nc_vals = np.asarray(nc[ref_nodes])
    stats.retain(nc_vals)
    node_coords = SparseVec(ref_nodes, nc_vals, n_node)

    # dof id lists restricted to the slab's referenced dofs (the full
    # list is the third O(n) transient — ids only, 4 bytes/entry)
    eff_all = np.asarray(_mm(p("DofEff.bin"), np.int32)[:n_dof_eff],
                         dtype=np.int64)
    stats.transient(eff_all.nbytes)
    dof_eff = np.intersect1d(eff_all, ref_dofs)
    fixed_all = np.asarray(_mm(p("FixedDof.bin"), np.int32)[:n_fixed],
                           dtype=np.int64)
    stats.transient(fixed_all.nbytes)
    fixed_dof = np.intersect1d(fixed_all, ref_dofs)
    stats.retain(dof_eff, fixed_dof)

    # ---- element library / materials / dt (small, full read) ----------
    Ke = scipy.io.loadmat(p("Ke.mat"))["Data"][0]
    Me = (scipy.io.loadmat(p("Me.mat"))["Data"][0]
          if os.path.exists(p("Me.mat")) else None)
    Se = (scipy.io.loadmat(p("Se.mat"))["Data"][0]
          if os.path.exists(p("Se.mat")) else None)
    elem_lib = {}
    for t in range(len(Ke)):
        Ket = np.asarray(Ke[t], float)
        elem_lib[t] = {
            "Ke": Ket, "diagKe": np.diag(Ket).copy(),
            "Me": np.asarray(Me[t], float) if Me is not None else None,
            "Se": np.asarray(Se[t], float) if Se is not None else None,
            "n_nodes": Ket.shape[0] // 3,
        }
    mat_raw = scipy.io.loadmat(p("MatProp.mat"),
                               struct_as_record=False)["Data"][0]
    mat_prop = [{"E": float(m.__dict__["E"][0][0]),
                 "Pos": float(m.__dict__["Pos"][0][0]),
                 "Rho": float(m.__dict__["Rho"][0][0])}
                for m in mat_raw]
    dt = (float(scipy.io.loadmat(p("dt.mat"))["Data"][0][0])
          if os.path.exists(p("dt.mat")) else 1.0)
    grid = None
    if os.path.exists(p("Grid.npz")):
        with np.load(p("Grid.npz")) as z:
            grid = (int(z["nx"]), int(z["ny"]), int(z["nz"]),
                    float(z["h"]))

    return ModelData(
        n_elem=ne, n_node=n_node, n_dof=n_dof,
        node_coords=node_coords, F=F, Ud=Ud, Vd=Vd, diag_M=diag_m,
        fixed_dof=fixed_dof, dof_eff=dof_eff,
        elem_type=elem_type,
        elem_nodes_flat=nodes_flat, elem_nodes_offset=nodes_offset,
        elem_dofs_flat=dofs_flat, elem_dofs_offset=dofs_offset,
        elem_sign_flat=signs_flat.astype(bool),
        ck=ck, cm=cm, ce=ce, level=level, poly_mat=poly_mat,
        sctrs=sctrs, elem_lib=elem_lib, mat_prop=mat_prop, dt=dt,
        grid=grid, elem_ids=e, glob_n_elem=n_elem,
    )


def _ragged_index(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Flat gather indices of the ragged slices [s, s+l) — repeat-based
    (zero-length slices pass through correctly; the cumsum-walk idiom
    ``parallel/partition._csr_take`` uses mis-steps on them)."""
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    starts = np.asarray(starts, dtype=np.int64)
    lens = np.asarray(lens, dtype=np.int64)
    offset = np.concatenate([[0], np.cumsum(lens)[:-1]])
    return (np.repeat(starts, lens)
            + np.arange(total, dtype=np.int64)
            - np.repeat(offset, lens))


def ingest_archive(archive_path: str, scratch_path: str,
                   model_name: Optional[str] = None) -> str:
    """Unpack a model archive into <scratch>/ModelData/MDF (reference
    read_input_model.py:23-39) and return the MDF path."""
    mdf_path = os.path.join(scratch_path, "ModelData", "MDF")
    os.makedirs(mdf_path, exist_ok=True)
    shutil.unpack_archive(archive_path, mdf_path)
    return mdf_path
