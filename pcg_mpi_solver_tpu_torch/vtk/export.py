"""Result visualization export: frames -> .vtu files.

Re-implements the reference's VTK exporter (src/data/export_vtk.py, 262 LoC)
on top of the RunStore, as the JAX package's ``vtk/export.py`` does (this
module is its copy): reassembles global nodal fields from owner-masked
per-frame payloads via the Dof/NodeId maps (reference: A[RefDof] = InpData,
export_vtk.py:251) and writes one .vtu per frame.

Modes (export_vtk.py:84-258):
- ``Full``      — every stored mesh face, fields on all nodes
- ``MidSlices`` — faces lying on the three mid-planes of the domain
- ``Boundary``  — faces with incidence exactly 1 over the stored face list
  (reference bincounts PolysFlat and keeps count==1 faces,
  export_vtk.py:105-113).  Models that store every element face (octree
  generator) get the true boundary; models that pre-store only boundary
  faces (structured cube) see every face count 1, which is already the
  boundary.
- ``Delaunay``  — tetrahedralization of the point cloud

All face selections are vectorized (length-grouped gathers — no per-face
Python loop), and the frame loop can fan out over a process pool
(``n_workers``), the host-side analogue of the reference round-robining
frames over MPI ranks (export_vtk.py:231).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from pcg_mpi_solver_tpu_torch.models.model_data import ModelData
from pcg_mpi_solver_tpu_torch.utils.io import RunStore
from pcg_mpi_solver_tpu_torch.vtk.writer import (
    VTK_POLYGON,
    VTK_TETRA,
    write_vtu,
)

SCALAR_VARS = ("D", "ES", "NS", "PS1", "PS2", "PS3", "PE1", "PE2", "PE3")


def _face_table(flat, offset):
    """Ragged faces -> list of (face_ids, (n, L) node array) per length."""
    lens = offset[1:] - offset[:-1]
    out = []
    for L in np.unique(lens):
        idx = np.where(lens == L)[0]
        cols = offset[idx][:, None] + np.arange(L)[None, :]
        out.append((idx, flat[cols]))
    return out


def _select_faces(model: ModelData, mode: str) -> np.ndarray:
    """Face ids (into model.faces_offset) selected by the export mode."""
    flat, offset = model.faces_flat, model.faces_offset
    n_faces = len(offset) - 1
    if mode == "Full":
        return np.arange(n_faces)

    if mode == "Boundary":
        # Face-incidence counting: interior faces are stored by both of
        # their cells, boundary faces once (export_vtk.py:105-113).
        keep = []
        for idx, arr in _face_table(flat, offset):
            key = np.sort(arr, axis=1)
            _, inv, counts = np.unique(key, axis=0, return_inverse=True,
                                       return_counts=True)
            keep.append(idx[counts[inv] == 1])
        return np.sort(np.concatenate(keep)) if keep else np.zeros(0, int)

    if mode == "MidSlices":
        # Faces whose nodes all lie on one of the three mid-planes
        # (reference export_vtk.py:86-103), fully vectorized.
        coords = model.node_coords
        lch = float(coords.max() - coords.min()) or 1.0
        table = _face_table(flat, offset)
        sel = []
        for axis in range(3):
            x = coords[:, axis]
            mid = 0.5 * (x.min() + x.max())
            on_plane = np.abs(x - mid) / lch < 1e-8
            for idx, arr in table:
                sel.append(idx[np.all(on_plane[arr], axis=1)])
        return np.unique(np.concatenate(sel)) if sel else np.zeros(0, int)

    raise ValueError(f"unknown mode {mode!r}")


def _faces_of(model: ModelData, mode: str):
    """(flat, offsets_1based_end, celltypes)"""
    if mode == "Delaunay":
        from scipy.spatial import Delaunay

        polys = Delaunay(model.node_coords).simplices
        flat = polys.ravel()
        offs = np.arange(1, len(polys) + 1) * 4
        return flat, offs, np.full(len(polys), VTK_TETRA, np.uint8)

    if model.faces_flat is None:
        raise ValueError("model has no face topology; use Delaunay mode")
    flat, offset = model.faces_flat, model.faces_offset
    sel = _select_faces(model, mode)

    lens = offset[1:] - offset[:-1]
    starts = offset[sel]
    sel_lens = lens[sel]
    if len(sel):
        # vectorized ragged gather
        reps = np.repeat(starts, sel_lens)
        within = np.arange(int(sel_lens.sum())) - np.repeat(
            np.cumsum(sel_lens) - sel_lens, sel_lens)
        sel_flat = flat[reps + within]
        sel_offs = np.cumsum(sel_lens)
    else:
        sel_flat, sel_offs = np.zeros(0, int), np.zeros(0, int)
    ctype = np.full(len(sel), VTK_POLYGON, np.uint8)
    return sel_flat, sel_offs, ctype


# Per-worker shared context: the model/points/face arrays are shipped ONCE
# per worker via the pool initializer (several hundred MB at bench scale —
# re-pickling them per frame would swamp the pool with IPC).
_FRAME_CTX = None


def _init_frame_ctx(ctx):
    global _FRAME_CTX
    _FRAME_CTX = ctx


def _write_frame_idx(i):
    return _write_frame((i,) + _FRAME_CTX)


def _write_frame(args):
    """One frame -> one .vtu (top-level function: picklable for the pool)."""
    (i, store, model, export_vars, dof_map, node_map,
     points, flat, offs, ctype) = args
    from pcg_mpi_solver_tpu_torch.utils.postproc import (
        global_dof_frame, global_nodal_frame)

    point_data = {}
    for var in export_vars:
        if var == "U":
            a = global_dof_frame(store, model, i, dof_map)
            if model.n_dof == model.n_node:
                # scalar problem class (Poisson): U is one value per node
                point_data["U"] = a
            else:
                point_data["U"] = (np.ascontiguousarray(a[0::3]),
                                   np.ascontiguousarray(a[1::3]),
                                   np.ascontiguousarray(a[2::3]))
        elif var in SCALAR_VARS:
            point_data[var] = global_nodal_frame(store, model, var, i,
                                                 node_map)
        else:
            raise ValueError(f"unknown export var {var!r}")
    path = f"{store.vtk_path}/{store.model_name}_{i}"
    return write_vtu(path, points, flat, offs, ctype, point_data=point_data)


def export_vtk(
    model: ModelData,
    store: RunStore,
    export_vars: Sequence[str] = ("U",),
    mode: str = "Full",
    frames: Optional[Sequence[int]] = None,
    n_workers: int = 0,
) -> list:
    """Write one .vtu per exported frame; returns the file list.

    ``n_workers > 1`` fans frames out over a spawn-based process pool
    (frames are independent; the reference uses ``i % N_Workers == Rank``
    round-robin over MPI ranks, export_vtk.py:231)."""
    os.makedirs(store.vtk_path, exist_ok=True)
    flat, offs, ctype = _faces_of(model, mode)

    dof_map = store.read_map("Dof")
    node_map = None
    if any(v in SCALAR_VARS for v in export_vars):
        node_map = store.read_map("NodeId")

    n_frames = store.n_frames(export_vars[0])
    if frames is None:
        frames = range(n_frames)

    points = (np.ascontiguousarray(model.node_coords[:, 0]),
              np.ascontiguousarray(model.node_coords[:, 1]),
              np.ascontiguousarray(model.node_coords[:, 2]))

    ctx = (store, model, tuple(export_vars), dof_map, node_map,
           points, flat, offs, ctype)
    frames = list(frames)
    if n_workers > 1 and len(frames) > 1:
        import multiprocessing as mp

        # spawn, not fork: the parent typically holds a CUDA context and
        # torch's threads (fork would risk deadlock).  The worker import
        # chain is numpy-only (this module, writer, io, postproc,
        # model_data: no torch), so a worker never initialises CUDA and
        # spawn startup is cheap.  The big shared
        # arrays go through the initializer once per worker; per-frame IPC
        # is just the frame index.
        with mp.get_context("spawn").Pool(
                min(n_workers, len(frames)),
                initializer=_init_frame_ctx, initargs=(ctx,)) as pool:
            written = pool.map(_write_frame_idx, frames)
    else:
        written = [_write_frame((i,) + ctx) for i in frames]

    # frame-time index (reference VTKInfo.txt, export_vtk.py:169-174)
    times = store.read_time_list()
    with open(f"{store.vtk_path}/VTKInfo.txt", "w") as f:
        f.write("%15s  %12s\n" % ("VTKFileCount", "Time (s)"))
        for i in range(n_frames):
            f.write("%15d  %12.2e\n" % (i, times[i]))
    return written
